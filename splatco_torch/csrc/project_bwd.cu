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
// computes, operation for operation (csrc/project.cuh): `forward`, then
// `vjp_view` and `vjp_rotation`.  A
// cotangent pointer may be null: a zero cotangent (an output autograd sent
// no gradient).  The camera gets no gradient, so nothing is summed across
// gaussians: no atomics, and the result does not depend on the launch.
//
// What bounds it: 40 B of inputs and up to 24 B of cotangents read and 40
// B of gradients written a gaussian (0.0391 ms at 1,310,720 rows and
// 3.35 TB/s), against ~1,000 instructions a row issued one at a time
// (--fmad=false: no multiply and add contract): ~720 fp32 operations and
// ~20 IEEE divisions of ~10 instructions each, about as long at the
// card's issue rate.  One thread a row in 256-thread blocks at 95
// registers (16 warps an SM) hid neither latency: 0.0852 ms, 0.46 of the
// bound (H100 80GB HBM3, 700 W; PERF.md row 9b).  The design:
// - 128-thread blocks capped at 80 registers (72 used, no spills): 7
//   blocks, 28 warps an SM;
// - the VJP in two parts: the mean's part (`forward`, `vjp_view`) first;
//   the normalised quaternion, the scale and the quaternion are parked in
//   shared memory before it and read back for the rotation's part
//   (`vjp_rotation`, R recomputed: the same operations, the same bits),
//   so they are not live in registers across the mean's part (one flow
//   needed 80 registers and spilled);
// - the two camera matrices read once a block, into shared memory;
// - the divisions that take a cotangent go through `project::div_cot`: a
//   zero dividend (the cotangent of a row that gets no gradient, 81 % of
//   a training view's) sent each of them down the division's slow path,
//   25 % of that view's time.
// Rows are read and written in place as [N, 3] / [N, 4] (a base 4, 8 or
// 12 B past 16 B, a view's storage offset, needs nothing): staging them
// through shared memory with 16 B `cp.async` copies measured 29 % slower
// (more instructions, a barrier between the loads and the arithmetic),
// and 16 B quaternion loads 1.5 % slower.
#include "project.cuh"

namespace {

constexpr int kRows = 128;  // rows a block, one a thread
constexpr int kBlocksPerSm = 6;  // caps registers at 80 (72 used)
// the rotation's part's inputs a row: n_raw, n, w, x, y, z, s, q
constexpr int kParked = 13;

__device__ __forceinline__ float cot(const float* __restrict__ g,
                                     long long i) {
  return g ? g[i] : 0.0f;
}

__global__ void __launch_bounds__(kRows, kBlocksPerSm)
project_bwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ scales,
                   const float* __restrict__ quats, long long n,
                   const float* __restrict__ vm,
                   const float* __restrict__ pm, float fx, float fy,
                   float limx, float limy, float width, float height,
                   const float* __restrict__ g_mx,
                   const float* __restrict__ g_my,
                   const float* __restrict__ g_depth,
                   const float* __restrict__ g_ca,
                   const float* __restrict__ g_cb,
                   const float* __restrict__ g_cc,
                   float* __restrict__ d_means, float* __restrict__ d_scales,
                   float* __restrict__ d_quats) {
  __shared__ float mats[32];  // vm, then pm
  __shared__ float parked[kParked][kRows];
  const int t = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * kRows + t;
  const bool live = i < n;
  if (t < 32) mats[t] = t < 16 ? vm[t] : pm[t - 16];
  float g[6] = {};
  if (live) {
    g[0] = cot(g_mx, i);
    g[1] = cot(g_my, i);
    g[2] = cot(g_depth, i);
    g[3] = cot(g_ca, i);
    g[4] = cot(g_cb, i);
    g[5] = cot(g_cc, i);
  }
  __syncthreads();
  if (!live) return;
  const project::Camera cam{mats, mats + 16, fx,    fy,
                            limx, limy,       width, height};
  // the mean's part, the rotation's inputs parked first (`forward`
  // normalises the quaternion again: the compiler computes it once)
  project::Cov3 g_sigma;
  {
    const project::Row in = project::load_row(means, scales, quats, i);
    const project::Quat u = project::normalise(in.q0, in.q1, in.q2, in.q3);
    const float park[kParked] = {u.n_raw, u.n,   u.w,   u.x,   u.y,
                                 u.z,     in.s0, in.s1, in.s2, in.q0,
                                 in.q1,   in.q2, in.q3};
    for (int k = 0; k < kParked; ++k) parked[k][t] = park[k];
    const project::ViewGrads d = project::vjp_view(
        project::forward(in, cam), cam, g[0], g[1], g[2], g[3], g[4], g[5]);
    for (int k = 0; k < 3; ++k) d_means[3 * i + k] = d.p[k];
    g_sigma = d.g;
  }

  // the rotation's part, from the parked values (volatile: read back from
  // shared memory, not kept in registers)
  float r[kParked];
  for (int k = 0; k < kParked; ++k)
    r[k] = *static_cast<volatile float*>(&parked[k][t]);
  const project::Quat u2{r[0], r[1], r[2], r[3], r[4], r[5]};
  const float s[3] = {r[6], r[7], r[8]};
  const float q[4] = {r[9], r[10], r[11], r[12]};
  float ds[3], dq[4];
  project::vjp_rotation(u2, project::rotation(u2), s, q, g_sigma, ds, dq);
  for (int k = 0; k < 3; ++k) d_scales[3 * i + k] = ds[k];
  for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = dq[k];
}

}  // namespace

// means, scales: [n, 3]; quats: [n, 4]; vm, pm: [4, 4]; the six
// cotangents [n] (mx, my, depth, conic a, b, c), each null for zeros; all
// float32, contiguous, on the device (4 B aligned: a view's storage
// offset is kept).  Writes d_means, d_scales [n, 3] and d_quats [n, 4].
// Launches on `stream` and returns cudaGetLastError().
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
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  project_bwd_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
      means, scales, quats, n, vm, pm, fx, fy, limx, limy, width, height,
      g_mx, g_my, g_depth, g_ca, g_cb, g_cc, d_means, d_scales, d_quats);
  return (int)cudaGetLastError();
}
