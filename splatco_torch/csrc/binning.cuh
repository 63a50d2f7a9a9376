// The tile binning's per-gaussian arithmetic, shared by bin_count.cu,
// bin_place.cu and bin_sort_tiles.cu.
//
// Replaces the XLA stage of the JAX package's binning: `bin_gaussians`
// (splatco_tpu/ops/binning.py:210, its `jax.lax.sort`s at :277 and :300)
// and `bin_gaussians_v3` (splatco_tpu/ops/raster_v3.py).  No Pallas kernel
// is replaced; the stage gets hand kernels because the H100 profile put it
// at most of the `_Rasterize` forward's device time (PERF.md).
//
// `rect_of` and `reaches` repeat `_rects` / `rect_bounds` and `_slot_grid`
// of splatco_torch/ops/binning.py float op for float op (built with
// --fmad=false, IEEE division, libdevice's logf as torch's CUDA `log`),
// with torch's NaN rules: `torch.clamp` and `torch.minimum` return a NaN
// operand where fminf / fmaxf would drop it, and a float -> int32 cast
// truncates (cvt.rzi, NaN -> 0), as torch's `.to(torch.int32)` does on the
// card.  The tile size is a power of two, so `c / tile` is exact, as
// torch's `c * (1 / tile)` is.
//
// `for_each_slot` visits a gaussian's reach-valid slots in the order of
// their rank, the row of `slot_pos` they land in: in v2 the raw slot index
// j (j-major over the clipped rect, gaps included); in v3 (parent_major)
// the rank among the valid slots in parent-major tile order, the 2x2
// 16 px tiles of a 32 px parent consecutive, as `parent_major_slots` of
// splatco_torch/ops/raster_v3.py sorts them.  The kernels do not keep a
// gaussian's slots between passes: each pass recomputes them (a few dozen
// float operations a slot), so no kmax is too large to hold.
//
// The sort key of a (tile, gaussian) pair within its tile is
// float_bits(depth) << 32 | (rank * N + n): depth is positive past the
// near clip, so its bits order like its value, and the low word (the
// pair's flat index in the [kmax, N] slot map, which the wrappers keep
// below 2^31) makes every key of a tile unique.  Sorting a tile's keys
// ascending is then the stable argsort of `tile << 32 | depth` over the
// j-major emission, whatever order the keys were placed in.
#pragma once

#include <cuda_runtime.h>

namespace binning {

struct Grid {
  int tile;         // pixels a tile side: 32 (v2) or 16 (v3)
  int tiles_x, tiles_y, num_tiles, kmax;
  bool parent_major;  // v3: ranks in parent-major tile order
};

// The per-gaussian columns the binning reads ([N] float32 each).
struct Columns {
  const float *mx, *my, *ca, *cb, *cc, *op, *radius;
  long long n;
};

// torch.clamp: a NaN value, then a NaN bound, comes back as it is
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.clamp_min with a scalar bound
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// rect_bounds' span: clamp(floor or ceil(c / tile), 0, n).to(int32)
__device__ __forceinline__ int span(float c, bool up, int tile, int n) {
  const float q = c / (float)tile;
  return (int)t_clamp(up ? ceilf(q) : floorf(q), 0.0f, (float)n);
}

struct Rect {
  int x0, y0, sx, sy;  // the clipped rect: sx x sy tiles from (x0, y0)
  int count;           // slots in it, 0 for a culled gaussian
  bool clipped;
};

// `_rects`: the gaussian's tile rect, clipped to kmax tiles around its
// centre.
__device__ __forceinline__ Rect rect_of(float mx, float my, float rad,
                                        const Grid& g) {
  int x0 = span(mx - rad, false, g.tile, g.tiles_x);
  int y0 = span(my - rad, false, g.tile, g.tiles_y);
  const int x1 = span(mx + rad, true, g.tile, g.tiles_x);
  const int y1 = span(my + rad, true, g.tile, g.tiles_y);
  const int sx = max(x1 - x0, 0), sy = max(y1 - y0, 0);
  Rect r;
  r.clipped = sx * sy > g.kmax && rad > 0.0f;
  // saturate before the cast, as XLA's float -> int conversion does
  const float lim = 1073741824.0f;  // 2^30
  const int cx = min(max((int)t_clamp(mx / (float)g.tile, -lim, lim), 0),
                     g.tiles_x - 1);
  const int cy = min(max((int)t_clamp(my / (float)g.tile, -lim, lim), 0),
                     g.tiles_y - 1);
  int sxc = min(sx, g.kmax);
  int syc = min(sy, max(g.kmax / max(sxc, 1), 1));
  sxc = min(sxc, max(g.kmax / max(syc, 1), 1));
  if (r.clipped) {
    x0 = min(max(cx - sxc / 2, x0), max(x1 - sxc, x0));
    y0 = min(max(cy - syc / 2, y0), max(y1 - syc, y0));
  } else {
    sxc = sx;
    syc = sy;
  }
  r.x0 = x0;
  r.y0 = y0;
  r.sx = sxc;
  r.sy = syc;
  r.count = rad > 0.0f ? sxc * syc : 0;
  return r;
}

// `_slot_grid`'s per-gaussian terms of the exact ellipse-reach test.
struct Ellipse {
  float mx, my, ca, cc, two_cb, r_vc, r_uc, rhs;
};

__device__ __forceinline__ Ellipse ellipse_of(float mx, float my, float ca,
                                              float cb, float cc, float op) {
  Ellipse e;
  e.mx = mx;
  e.my = my;
  e.ca = ca;
  e.cc = cc;
  e.two_cb = 2.0f * cb;
  e.r_vc = -cb / (cc != 0.0f ? cc : 1.0f);
  e.r_uc = -cb / (ca != 0.0f ? ca : 1.0f);
  e.rhs = 2.0f * logf(255.0f * t_clamp_min(op, (float)1e-12));
  return e;
}

// Whether the gaussian's alpha reaches 1/255 somewhere on tile (tx, ty):
// the conic's minimum over the tile's pixel square (0 if it holds the
// centre, else the least over its four edges) against 2 log(255 op).
__device__ __forceinline__ bool reaches(const Ellipse& e, int tx, int ty,
                                        int tile) {
  const float u0 = (float)(tx * tile) - e.mx;
  const float u1 = u0 + (float)(tile - 1);
  const float v0 = (float)(ty * tile) - e.my;
  const float v1 = v0 + (float)(tile - 1);
  auto edge_u = [&](float u) {
    const float vs = t_clamp(e.r_vc * u, v0, v1);
    return (e.ca * u * u + e.two_cb * u * vs) + e.cc * vs * vs;
  };
  auto edge_v = [&](float v) {
    const float us = t_clamp(e.r_uc * v, u0, u1);
    return (e.ca * us * us + e.two_cb * us * v) + e.cc * v * v;
  };
  const bool inside = u0 <= 0.0f && 0.0f <= u1 && v0 <= 0.0f && 0.0f <= v1;
  float qmin = t_min(t_min(edge_u(u0), edge_u(u1)),
                     t_min(edge_v(v0), edge_v(v1)));
  if (inside) qmin = 0.0f;
  return qmin * (float)(1.0 - 1e-3) <= e.rhs;
}

// Calls f(tile, rank) for each reach-valid slot of the gaussian, in rank
// order; returns how many there were.
template <class F>
__device__ __forceinline__ int for_each_slot(const Rect& r, const Ellipse& e,
                                             const Grid& g, F&& f) {
  const int w = max(r.sx, 1);
  const int slots = min(r.count, g.kmax);
  int valid = 0;
  if (!g.parent_major) {
    for (int j = 0; j < slots; ++j) {
      const int tx = r.x0 + j % w, ty = r.y0 + j / w;
      if (reaches(e, tx, ty, g.tile)) {
        f(ty * g.tiles_x + tx, j);
        ++valid;
      }
    }
    return valid;
  }
  if (slots == 0) return 0;
  const int rows = (slots + w - 1) / w;  // the rect rows the slots reach
  const int px1 = (r.x0 + w - 1) >> 1, py1 = (r.y0 + rows - 1) >> 1;
  for (int py = r.y0 >> 1; py <= py1; ++py) {
    for (int px = r.x0 >> 1; px <= px1; ++px) {
      for (int sub = 0; sub < 4; ++sub) {
        const int tx = 2 * px + (sub & 1), ty = 2 * py + (sub >> 1);
        const int lx = tx - r.x0, ly = ty - r.y0;
        if (lx < 0 || lx >= w || ly < 0 || ly * w + lx >= slots) continue;
        if (reaches(e, tx, ty, g.tile)) {
          f(ty * g.tiles_x + tx, valid);
          ++valid;
        }
      }
    }
  }
  return valid;
}

// Visits gaussian n's valid slots (see for_each_slot); returns their count
// and sets *clipped.
template <class F>
__device__ __forceinline__ int visit_gaussian(const Columns& c, long long n,
                                              const Grid& g, bool* clipped,
                                              F&& f) {
  const Rect r = rect_of(c.mx[n], c.my[n], c.radius[n], g);
  *clipped = r.clipped;
  if (r.count == 0) return 0;
  const Ellipse e = ellipse_of(c.mx[n], c.my[n], c.ca[n], c.cb[n], c.cc[n],
                               c.op[n]);
  return for_each_slot(r, e, g, f);
}

// Tiles whose per-block counters fit in shared memory (48 KiB of int32,
// the most a kernel gets without asking); a larger grid counts in global
// memory directly.
constexpr int kSharedTiles = 12288;

}  // namespace binning
