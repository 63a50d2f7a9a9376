// The EWA projection's VJP: the gradients of each gaussian's mean, scale
// and quaternion from the cotangents of its pixel mean, depth and conic.
//
// Replaces no Pallas kernel: the JAX package takes `jax.grad` of the XLA
// projection (splatco_tpu/ops/projection.py:170-280).  Autograd through
// the eager formula ran ~560 launches and kept ~40 [N] intermediates for
// the backward; this keeps only the inputs and recomputes the forward's
// values a gaussian at a time.
//
// Computes what `_project_bwd_plain` (splatco_torch/ops/projection.py)
// computes, operation for operation: `project::forward` then
// `project::vjp` (csrc/project.cuh).  A cotangent pointer may be null: a
// zero cotangent (an output autograd sent no gradient).  The camera gets
// no gradient, so nothing is summed across gaussians: no atomics, and
// the result does not depend on the launch.
//
// What bounds it: bytes, 40 B of inputs and 24 B of cotangents read and
// 40 B of gradients written a gaussian against ~720 fp32 operations,
// below the card's ~20 operations a byte.  One thread a gaussian,
// 256-thread blocks; rows read and written as [N, 3] / [N, 4].
#include "project.cuh"

namespace {

using project::kThreads;

__device__ __forceinline__ float cot(const float* __restrict__ g,
                                     long long i) {
  return g ? g[i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ scales,
                   const float* __restrict__ quats, long long n,
                   project::Camera cam, const float* __restrict__ g_mx,
                   const float* __restrict__ g_my,
                   const float* __restrict__ g_depth,
                   const float* __restrict__ g_ca,
                   const float* __restrict__ g_cb,
                   const float* __restrict__ g_cc,
                   float* __restrict__ d_means, float* __restrict__ d_scales,
                   float* __restrict__ d_quats) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const project::Row in = project::load_row(means, scales, quats, i);
  const project::Terms t = project::forward(in, cam);
  const project::Grads d = project::vjp(
      in, t, cam, cot(g_mx, i), cot(g_my, i), cot(g_depth, i), cot(g_ca, i),
      cot(g_cb, i), cot(g_cc, i));
  for (int k = 0; k < 3; ++k) {
    d_means[3 * i + k] = d.p[k];
    d_scales[3 * i + k] = d.s[k];
  }
  for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = d.q[k];
}

}  // namespace

// means, scales: [n, 3]; quats: [n, 4]; vm, pm: [4, 4]; the six
// cotangents [n] (mx, my, depth, conic a, b, c), each null for zeros; all
// float32, contiguous, on the device.  Writes d_means, d_scales [n, 3] and
// d_quats [n, 4].  Launches on `stream` and returns cudaGetLastError().
extern "C" int project_bwd(const float* means, const float* scales,
                           const float* quats, long long n, const float* vm,
                           const float* pm, float fx, float fy, float limx,
                           float limy, float width, float height,
                           const float* g_mx, const float* g_my,
                           const float* g_depth, const float* g_ca,
                           const float* g_cb, const float* g_cc,
                           float* d_means, float* d_scales, float* d_quats,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const project::Camera cam{vm, pm, fx, fy, limx, limy, width, height};
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  project_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      means, scales, quats, n, cam, g_mx, g_my, g_depth, g_ca, g_cb, g_cc,
      d_means, d_scales, d_quats);
  return (int)cudaGetLastError();
}
