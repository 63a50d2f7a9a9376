// The tri-plane sampler's per-row arithmetic, shared by the forward
// (plane_sample_fwd.cu) and the backward (plane_sample_bwd.cu), so both
// compute a row's cell, weights and corner texels as `_sample_plane` in
// splatco_torch/ops/plane_sample.py does, operation for operation (built
// with --fmad=false: no product is fused into a sum).
//
// A plane is [R, H, W], row-major; u runs along H, v along W, both in
// [-1, 1] with align_corners (u = -1 and u = 1 are the centres of the
// first and last texel).  Corner k of a row: bit 0 steps x, bit 1 steps y,
// so k = 0, 1, 2, 3 are (x0, y0), (x0 + 1, y0), (x0, y0 + 1),
// (x0 + 1, y0 + 1), the order of the plain version's sum.
#pragma once

#include <cuda_runtime.h>

namespace plane_sample {

// channels whose texels (or cotangents) one batch of loads fetches: a
// row's loads for up to kGroup channels are issued back to back
constexpr int kGroup = 2;

struct Cell {
  float x0, y0, tx, ty;
};

__device__ __forceinline__ Cell cell_of(float u, float v, int h, int w) {
  const float x = ((u + 1.0f) * 0.5f) * (float)(h - 1);
  const float y = ((v + 1.0f) * 0.5f) * (float)(w - 1);
  Cell c;
  c.x0 = floorf(x);
  c.y0 = floorf(y);
  c.tx = x - c.x0;
  c.ty = y - c.y0;
  return c;
}

// Corner k's bilinear weight; `inb` whether it lies on the plane and
// (ix, iy) its texel clamped onto the plane, flat index ix * W + iy (the
// plain version reads the clamped texel and multiplies it by 0 outside).
__device__ __forceinline__ float corner(const Cell& c, int k, int h, int w,
                                        bool* inb, int* ix, int* iy) {
  const float cx = (k & 1) ? c.x0 + 1.0f : c.x0;
  const float cy = (k & 2) ? c.y0 + 1.0f : c.y0;
  const float wx = (k & 1) ? c.tx : 1.0f - c.tx;
  const float wy = (k & 2) ? c.ty : 1.0f - c.ty;
  const float hm = (float)(h - 1), wm = (float)(w - 1);
  *inb = cx >= 0.0f && cx <= hm && cy >= 0.0f && cy <= wm;
  *ix = (int)fminf(fmaxf(cx, 0.0f), hm);
  *iy = (int)fminf(fmaxf(cy, 0.0f), wm);
  return wx * wy;
}

// A row's four corners: weights, in-bounds flags and clamped texels.
struct Corners {
  float wgt[4];
  bool inb[4];
  int ix[4], iy[4];
};

__device__ __forceinline__ Corners corners_of(const Cell& c, int h, int w) {
  Corners q;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q.wgt[k] = corner(c, k, h, w, &q.inb[k], &q.ix[k], &q.iy[k]);
  return q;
}

}  // namespace plane_sample
