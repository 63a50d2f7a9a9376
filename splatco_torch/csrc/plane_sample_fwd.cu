// Tri-plane bilinear sample, forward: a gather of four texels a row.
//
// Replaces no Pallas kernel: the JAX package samples each plane with the
// XLA gather `flat[idx]` of `_sample_plane`
// (splatco_tpu/models/triplane.py:51).  It gets a hand kernel because the
// H100 profile of a trained step put the sampler's backward at 54 % of
// the device time (PERF.md); this forward also writes the key table that
// backward needs.
//
// Computes what `plane_sample_fwd_plain` (splatco_torch/ops/
// plane_sample.py) computes, operation for operation: out[n, r] = the sum
// over the four corners, in corner order, of plane[r, corner] times
// (weight times the corner's in-bounds flag).  With `keys` given it also
// writes keys[4 n + k], corner k's flat cell index, or H * W where the
// corner lies off the plane.
//
// What bounds it: bytes, the four texels a row and channel gathered from
// device memory or L2, the output written once.  One thread per (row,
// channel): neighbouring threads write neighbouring outputs, and the R
// threads of a row read its coordinates once from L1.  The [R, H, W]
// layout puts a row's channels H * W floats apart, so each channel's
// gather is its own 32-byte sector.
#include "plane_sample.cuh"

namespace {

using plane_sample::Cell;
using plane_sample::cell_of;
using plane_sample::corner;

__global__ void __launch_bounds__(256)
sample_gather(const float* __restrict__ plane, const float* __restrict__ u,
              long long su, const float* __restrict__ v, long long sv,
              long long n, int r, int h, int w, float* __restrict__ out,
              int* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * r) return;
  const long long row = i / r;
  const int ch = (int)(i - row * r);
  const Cell c = cell_of(u[row * su], v[row * sv], h, w);
  const float* p = plane + (long long)ch * h * w;
  float term[4];
  for (int k = 0; k < 4; ++k) {
    bool inb;
    int idx;
    const float wgt = corner(c, k, h, w, &inb, &idx);
    term[k] = p[idx] * (wgt * (inb ? 1.0f : 0.0f));
    if (keys != nullptr && ch == 0) keys[4 * row + k] = inb ? idx : h * w;
  }
  out[i] = ((term[0] + term[1]) + term[2]) + term[3];
}

}  // namespace

// plane: [r, h, w] float32, contiguous; u, v: [n] float32 with element
// strides su, sv; out: [n, r] float32, contiguous; keys: [4 n] int32 or
// null.  Launches on `stream` and returns cudaGetLastError().
extern "C" int plane_sample_fwd(const float* plane, const float* u,
                                long long su, const float* v, long long sv,
                                long long n, int r, int h, int w, float* out,
                                int* keys, void* stream) {
  const long long total = n * r;
  if (total > 0) {
    sample_gather<<<(unsigned)((total + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(plane, u, su, v, sv, n, r, h, w,
                                            out, keys);
  }
  return (int)cudaGetLastError();
}
