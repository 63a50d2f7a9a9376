// Tri-plane bilinear sample, forward: a gather of four texels a row and
// channel.
//
// Replaces no Pallas kernel: the JAX package samples each plane with the
// XLA gather `flat[idx]` of `_sample_plane`
// (splatco_tpu/models/triplane.py:51).  It gets a hand kernel because the
// H100 profile of a trained step put the sampler's autograd backward at
// 54 % of the device time (PERF.md), and this forward is its pair.
//
// Computes what `plane_sample_fwd_plain` (splatco_torch/ops/
// plane_sample.py) computes, operation for operation: out[n, r] = the sum
// over the four corners, in corner order, of plane[r, corner] times
// (weight times the corner's in-bounds flag).
//
// What bounds it: bytes, the texels gathered from L2 (the [R, H, W]
// layout puts a row's channels H * W floats apart, so each channel's
// corners are their own sectors) and the output written once.  One thread
// per row: the cell, weights and corner indices are computed once a row,
// not once a channel, and a row's texel loads for kGroup channels are
// issued back to back, 4 kGroup loads in flight a thread.  The block's
// [rows, R] outputs are staged in shared memory and stored as one
// contiguous, coalesced span.  The coordinates may be strided columns.
#include "plane_sample.cuh"

namespace {

using plane_sample::Cell;
using plane_sample::cell_of;
using plane_sample::Corners;
using plane_sample::corners_of;
using plane_sample::kGroup;

constexpr int kRows = 512;  // rows a block, one a thread

__global__ void __launch_bounds__(kRows)
sample_gather(const float* __restrict__ plane, const float* __restrict__ u,
              long long su, const float* __restrict__ v, long long sv,
              long long n, int r, int h, int w, float* __restrict__ out) {
  extern __shared__ float s_out[];  // [kRows, r]
  const long long first = (long long)blockIdx.x * kRows;
  const long long row = first + threadIdx.x;
  const int rows = (int)min((long long)kRows, n - first);
  if (row < n) {
    const Corners q = corners_of(cell_of(u[row * su], v[row * sv], h, w),
                                 h, w);
    int idx[4];
    float wm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      idx[k] = q.ix[k] * w + q.iy[k];
      wm[k] = q.wgt[k] * (q.inb[k] ? 1.0f : 0.0f);
    }
    const long long cells = (long long)h * w;
    for (int r0 = 0; r0 < r; r0 += kGroup) {
      float t[kGroup][4];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (r0 + j < r) {
          const float* p = plane + (r0 + j) * cells;
#pragma unroll
          for (int k = 0; k < 4; ++k) t[j][k] = p[idx[k]];
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (r0 + j < r) {
          s_out[threadIdx.x * r + r0 + j] =
              ((t[j][0] * wm[0] + t[j][1] * wm[1]) + t[j][2] * wm[2]) +
              t[j][3] * wm[3];
        }
      }
    }
  }
  __syncthreads();
  float* dst = out + first * r;  // the block's rows are one contiguous span
  for (int i = threadIdx.x; i < rows * r; i += kRows) dst[i] = s_out[i];
}

}  // namespace

// plane: [r, h, w] float32, contiguous; u, v: [n] float32 with element
// strides su, sv; out: [n, r] float32, contiguous.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int plane_sample_fwd(const float* plane, const float* u,
                                long long su, const float* v, long long sv,
                                long long n, int r, int h, int w, float* out,
                                void* stream) {
  const int smem = (int)sizeof(float) * kRows * r;
  if (smem > 48 * 1024) {  // above 48 KiB a kernel must ask for it
    const cudaError_t err = cudaFuncSetAttribute(
        sample_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    sample_gather<<<(unsigned)((n + kRows - 1) / kRows), kRows, smem,
                    (cudaStream_t)stream>>>(plane, u, su, v, sv, n, r, h, w,
                                            out);
  }
  return (int)cudaGetLastError();
}
