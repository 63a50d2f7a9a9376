// The tile binning's per-gaussian arithmetic and its warp-wide slot
// enumeration, shared by bin_count.cu and bin_place.cu.
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
// card.  The tile size is a power of two, so `c * (1 / tile)`, as torch
// computes `c / tile`, is exact.
//
// `warp_slots` enumerates the slots of a warp's 32 rows slot-parallel: a
// lane computes its row's clipped rect (a row of radius 0 costs the load
// of its radius), the rows with slots move to the low lanes, the warp
// prefix-sums their slot counts, and the lanes then walk the warp's slots
// 32 at a time, each finding its (gaussian, enumeration index) from the
// owners' starts in its round and running that slot's reach test, so a
// warp no longer waits for its largest rect.  A slot's rank, the row of
// `slot_pos` it lands in, is in v2 the raw slot index j (j-major over the
// clipped rect, gaps included); in v3 (parent_major) the rank among the
// valid slots in parent-major tile order, the 2x2 16 px tiles of a 32 px
// parent consecutive, as `parent_major_slots` of
// splatco_torch/ops/raster_v3.py sorts them: v3 enumerates the rect in
// that order and counts the valid slots before each by ballot, carrying a
// gaussian's count from one round to the next.  Nothing of a gaussian is
// kept between kernels: each recomputes its slots (a few dozen float
// operations a slot), so no kmax is too large to hold.
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

// torch.clamp_min with a scalar bound
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// rect_bounds' span: clamp(floor or ceil(c / tile), 0, n).to(int32)
__device__ __forceinline__ int span(float c, bool up, float inv_tile, int n) {
  const float q = c * inv_tile;
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
  const float inv = 1.0f / (float)g.tile;
  int x0 = span(mx - rad, false, inv, g.tiles_x);
  int y0 = span(my - rad, false, inv, g.tiles_y);
  const int x1 = span(mx + rad, true, inv, g.tiles_x);
  const int y1 = span(my + rad, true, inv, g.tiles_y);
  const int sx = max(x1 - x0, 0), sy = max(y1 - y0, 0);
  Rect r;
  r.clipped = sx * sy > g.kmax && rad > 0.0f;
  // saturate before the cast, as XLA's float -> int conversion does
  const float lim = 1073741824.0f;  // 2^30
  const int cx = min(max((int)t_clamp(mx * inv, -lim, lim), 0),
                     g.tiles_x - 1);
  const int cy = min(max((int)t_clamp(my * inv, -lim, lim), 0),
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
// Branch-free, and the same boolean as torch's NaN rules give: torch's
// minimum is NaN exactly when a clamp's value or bound or an edge is NaN
// (then only a tile holding the centre can pass), and where none is,
// fminf / fmaxf are torch's clamp and minimum.
__device__ __forceinline__ bool reaches(const Ellipse& e, int tx, int ty,
                                        int tile) {
  const float u0 = (float)(tx * tile) - e.mx;
  const float u1 = u0 + (float)(tile - 1);
  const float v0 = (float)(ty * tile) - e.my;
  const float v1 = v0 + (float)(tile - 1);
  const float vu0 = e.r_vc * u0, vu1 = e.r_vc * u1;
  const float uv0 = e.r_uc * v0, uv1 = e.r_uc * v1;
  auto edge_u = [&](float u, float vu) {
    const float vs = fminf(fmaxf(vu, v0), v1);
    return (e.ca * u * u + e.two_cb * u * vs) + e.cc * vs * vs;
  };
  auto edge_v = [&](float v, float uv) {
    const float us = fminf(fmaxf(uv, u0), u1);
    return (e.ca * us * us + e.two_cb * us * v) + e.cc * v * v;
  };
  const float a = edge_u(u0, vu0), b = edge_u(u1, vu1);
  const float c = edge_v(v0, uv0), d = edge_v(v1, uv1);
  // u1, v1 are NaN only with u0, v0; `|`, not `||`: no branches
  const bool nan = isnan(u0) | isnan(v0) | isnan(vu0) | isnan(vu1) |
                   isnan(uv0) | isnan(uv1) | isnan(a) | isnan(b) |
                   isnan(c) | isnan(d);
  const bool inside = u0 <= 0.0f && 0.0f <= u1 && v0 <= 0.0f && 0.0f <= v1;
  const float qmin = fminf(fminf(a, b), fminf(c, d));
  return inside ? 0.0f <= e.rhs
                : !nan && qmin * (float)(1.0 - 1e-3) <= e.rhs;
}

constexpr unsigned kFull = 0xffffffffu;

// The lanes below `k` (k in [0, 32]).
__device__ __forceinline__ unsigned lanes_below(int k) {
  return k >= 32 ? kFull : (1u << k) - 1u;
}

// e / w for 0 <= e and 1 <= w: below 2^22 an approximate float quotient
// (off by at most one there) corrected by one step.
__device__ __forceinline__ int quotient(int e, int w) {
  if (e >= (1 << 22)) return e / w;
  int q = (int)__fdividef((float)e, (float)w);
  const int r = e - q * w;
  return q + (r >= w) - (r < 0);
}

// Tile (tx, ty) of enumeration index e of a w x h rect at (x0, y0): in v2
// row by row (e is the slot index j); in v3 parent by parent (the 2x2
// 16 px tiles of a 32 px parent, row-major within it), parent rows top to
// bottom and parents left to right in a row, the tiles outside the rect
// skipped, as `parent_major_slots` orders them.
template <bool kParentMajor>
__device__ __forceinline__ void slot_tile(int e, int x0, int y0, int w,
                                          int h, int* tx, int* ty) {
  const int row = quotient(e, w);
  if (!kParentMajor) {
    *tx = x0 + (e - row * w);
    *ty = y0 + row;
    return;
  }
  // a parent row holds rin rect rows (1 or 2): w * rin indices
  const int py = (y0 + row) >> 1;
  const int rs = max(2 * py, y0);
  const bool two_rows = min(2 * py + 2, y0 + h) - rs == 2;
  const int e2 = e - w * (rs - y0);
  // a parent of that row holds rin x cin tiles (cin 1 or 2)
  const int px = (x0 + (two_rows ? e2 >> 1 : e2)) >> 1;
  const int cs = max(2 * px, x0);
  const bool two_cols = min(2 * px + 2, x0 + w) - cs == 2;
  const int e3 = e2 - (two_rows ? 2 : 1) * (cs - x0);
  *ty = rs + (two_cols ? e3 >> 1 : e3);
  *tx = cs + (two_cols ? e3 & 1 : 0);
}

// What warp_slots hands f for each lane of a round.
struct Slot {
  bool valid;  // a slot of some row whose reach test passed
  int tile;    // its tile (-1 where !valid)
  int rank;    // its rank, the row of slot_pos it lands in
  int owner;   // the lane holding its row's terms
  int row;     // its row, from row0
};

// The slots of rows row0 .. row0 + 31, one row a lane: f(slot) is called
// by every lane of the warp once a round (so f may use full-warp
// intrinsics), 32 slots a round in enumeration order.  The rows with
// slots are first moved to the low lanes, in row order.  Sets *clipped to
// the warp's rows whose rect was clipped and returns the valid slots of
// the row the lane then holds (0 on the lanes left over).  `depth_bits`
// is that row's depth as bits when `depth` is given (else 0), for f to
// shuffle from the slot's owner.  kParentMajor: v3's ranks
// (g.parent_major).
template <bool kParentMajor, class F>
__device__ __forceinline__ int warp_slots(const Columns& c, const Grid& g,
                                          long long row0, const float* depth,
                                          unsigned* depth_bits, int* clipped,
                                          F&& f) {
  const int lane = threadIdx.x & 31;
  const long long n = row0 + lane;
  const float rad = n < c.n ? c.radius[n] : 0.0f;
  Rect r{0, 0, 0, 0, 0, false};
  Ellipse e{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  *depth_bits = 0;
  if (rad > 0.0f) {
    const float mx = c.mx[n], my = c.my[n];
    r = rect_of(mx, my, rad, g);
    if (r.count > 0) {
      e = ellipse_of(mx, my, c.ca[n], c.cb[n], c.cc[n], c.op[n]);
      if (depth) *depth_bits = __float_as_uint(depth[n]);
    }
  }
  *clipped = __popc(__ballot_sync(kFull, r.clipped));
  // the k-th row with slots moves to lane k, so a slot's owner is found
  // from the owners' starts in its round
  const unsigned has = __ballot_sync(kFull, r.count > 0);
  const int src = __popc(has) > lane ? __fns(has, 0, lane + 1) : lane;
  const int moved = __shfl_sync(kFull, min(r.count, g.kmax), src);
  const int count = __popc(has) > lane ? moved : 0;
  r.x0 = __shfl_sync(kFull, r.x0, src);
  r.y0 = __shfl_sync(kFull, r.y0, src);
  r.sx = __shfl_sync(kFull, r.sx, src);
  r.sy = __shfl_sync(kFull, r.sy, src);
  e.mx = __shfl_sync(kFull, e.mx, src);
  e.my = __shfl_sync(kFull, e.my, src);
  e.ca = __shfl_sync(kFull, e.ca, src);
  e.cc = __shfl_sync(kFull, e.cc, src);
  e.two_cb = __shfl_sync(kFull, e.two_cb, src);
  e.r_vc = __shfl_sync(kFull, e.r_vc, src);
  e.r_uc = __shfl_sync(kFull, e.r_uc, src);
  e.rhs = __shfl_sync(kFull, e.rhs, src);
  *depth_bits = __shfl_sync(kFull, *depth_bits, src);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - count;
  const int total = __shfl_sync(kFull, incl, 31);
  const int w = max(r.sx, 1);
  int valid_here = 0;  // this lane's row's valid slots so far
  for (int base = 0; base < total; base += 32) {
    const int s = base + lane;
    // the owner: the lanes wholly before the round, then one more for
    // each owner that starts in the round at or before this lane
    const bool meets = count > 0 && excl < base + 32 && incl > base;
    const unsigned starts = __reduce_or_sync(
        kFull, meets ? 1u << (max(excl, base) - base) : 0u);
    const int o = __popc(__ballot_sync(kFull, count > 0 && incl <= base)) +
                  __popc(starts & lanes_below(lane + 1)) - 1;
    const int o_excl = __shfl_sync(kFull, excl, o);
    const int ox0 = __shfl_sync(kFull, r.x0, o);
    const int oy0 = __shfl_sync(kFull, r.y0, o);
    const int ow = __shfl_sync(kFull, w, o);
    const int oh = __shfl_sync(kFull, r.sy, o);
    const int o_before = __shfl_sync(kFull, valid_here, o);
    Ellipse oe;
    oe.mx = __shfl_sync(kFull, e.mx, o);
    oe.my = __shfl_sync(kFull, e.my, o);
    oe.ca = __shfl_sync(kFull, e.ca, o);
    oe.cc = __shfl_sync(kFull, e.cc, o);
    oe.two_cb = __shfl_sync(kFull, e.two_cb, o);
    oe.r_vc = __shfl_sync(kFull, e.r_vc, o);
    oe.r_uc = __shfl_sync(kFull, e.r_uc, o);
    oe.rhs = __shfl_sync(kFull, e.rhs, o);
    const bool live = s < total;
    const int j = s - o_excl;
    // branch-free: a dead lane tests some tile of the owner's rect
    int tx, ty;
    slot_tile<kParentMajor>(live ? j : 0, ox0, oy0, ow, oh, &tx, &ty);
    const bool reach = reaches(oe, tx, ty, g.tile);
    const bool valid = live && reach;
    const unsigned vm = __ballot_sync(kFull, valid);
    // the owner's slots in this round are lanes [max(o_excl, base) - base,
    // min(o_incl, base + 32) - base)
    const int lo = max(o_excl, base) - base;
    const int rank = kParentMajor
        ? o_before + __popc(vm & lanes_below(lane) & ~lanes_below(lo))
        : j;
    if (count > 0) {
      const int mlo = max(excl, base) - base;
      const int mhi = min(incl, base + 32) - base;
      if (mlo < mhi)
        valid_here += __popc(vm & lanes_below(mhi) & ~lanes_below(mlo));
    }
    f(Slot{valid, valid ? ty * g.tiles_x + tx : -1, rank, o,
           __shfl_sync(kFull, src, o)});
  }
  return valid_here;
}

// The lane's group of lanes with the same tile, its leader (the lowest
// lane of the group) and the lane's rank in it.
struct Group {
  unsigned lanes;
  int leader, rank;
};

__device__ __forceinline__ Group group_of(int tile) {
  const unsigned lanes = __match_any_sync(kFull, tile);
  const int lane = threadIdx.x & 31;
  return Group{lanes, __ffs(lanes) - 1, __popc(lanes & lanes_below(lane))};
}

// Tiles whose per-block counters fit in shared memory: 224 KiB of int32,
// within the 227 KiB a block may ask for (cudaFuncSetAttribute), with
// room for the kernels' static shared memory; a larger grid counts in
// global memory directly.
constexpr int kSharedTiles = 57344;

// Rows a warp takes at a time.
constexpr int kWarpRows = 32;

}  // namespace binning
