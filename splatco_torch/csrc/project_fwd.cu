// The EWA projection, forward: each gaussian's pixel mean, depth, conic
// and radius from its mean, scale and quaternion.
//
// Replaces no Pallas kernel: in the JAX package the projection is plain
// XLA, `covariance_cols` and `project_cols`
// (splatco_tpu/ops/projection.py:170-280), fused by XLA into one
// elementwise program.  Eager PyTorch ran it as ~280 launches over [N]
// columns, each read and written through HBM; here it is one.
//
// Computes what `covariance_cols` followed by `project_cols`
// (splatco_torch/ops/projection.py) compute, operation for operation:
// `project::forward` (csrc/project.cuh).  With kRadiusOnly (the anchor
// prefilter, which keeps radius > 0 alone) only the radius is written.
//
// What bounds it: bytes, 40 B of inputs read and 28 B of outputs written
// a gaussian (4 B with kRadiusOnly) against ~300 fp32 operations, below
// the card's ~20 operations a byte.  One thread a gaussian, 256-thread
// blocks; the inputs are read as [N, 3] / [N, 3] / [N, 4] rows (12, 12
// and 16 B strides), the outputs stored as [7, N] column planes.
#include "project.cuh"

namespace {

using project::kThreads;

template <bool kRadiusOnly>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ scales,
                   const float* __restrict__ quats, long long n,
                   project::Camera cam, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const project::Row in = project::load_row(means, scales, quats, i);
  const project::Terms t = project::forward(in, cam);
  const float mx = project::pixel(t.hx, t.p_w, cam.width);
  const float my = project::pixel(t.hy, t.p_w, cam.height);
  const float radius = project::radius(t, mx, my, cam);
  if (kRadiusOnly) {
    out[i] = radius;
    return;
  }
  out[i] = mx;
  out[n + i] = my;
  out[2 * n + i] = t.tz;
  out[3 * n + i] = t.cov11 * t.inv_det;
  out[4 * n + i] = -t.cov01 * t.inv_det;
  out[5 * n + i] = t.cov00 * t.inv_det;
  out[6 * n + i] = radius;
}

}  // namespace

// means, scales: [n, 3]; quats: [n, 4]; vm, pm: [4, 4]; all float32,
// contiguous, on the device.  out: [7, n] (mx, my, depth, conic a, b, c,
// radius), or [n] (radius) with radius_only.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int project_fwd(const float* means, const float* scales,
                           const float* quats, long long n, const float* vm,
                           const float* pm, float fx, float fy, float limx,
                           float limy, float width, float height,
                           int radius_only, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const project::Camera cam{vm, pm, fx, fy, limx, limy, width, height};
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (radius_only)
    project_fwd_kernel<true><<<grid, kThreads, 0, s>>>(means, scales, quats,
                                                       n, cam, out);
  else
    project_fwd_kernel<false><<<grid, kThreads, 0, s>>>(means, scales, quats,
                                                        n, cam, out);
  return (int)cudaGetLastError();
}
