// Tri-plane bilinear sample, backward: the output's cotangent scattered
// onto the plane's texels as exact integer sums, and the coordinates'
// gradients.
//
// Replaces no Pallas kernel: `jax.grad` of the XLA gather in
// `_sample_plane` (splatco_tpu/models/triplane.py:51) is an XLA
// scatter-add.  The port's autograd emitted `index_put_(accumulate=True)`
// for it, which walked each texel's entries serially in one warp: after a
// capacity regrowth ~87,000 zero padding rows sample the same four texels,
// and those walks took 186 ms of a 390 ms trained step (PERF.md).
//
// Computes what `plane_sample_bwd_plain` (splatco_torch/ops/
// plane_sample.py) computes, bit for bit:
//   d_plane[r, texel] = float(S) * 2^-k, S = the int64 sum over the rows'
//     in-bounds corners at `texel` of round_half_even(float32(g[n, r] *
//     weight(n, corner)) * 2^k), with k = `grad_exponent(max|g|, n)`: from
//     integer exponents, n * max|g| * 2^k <= 2^62 (within a factor of 4
//     of the largest k that keeps it so), clamped to [-126, 126]; no sum
//     can overflow (a row's in-bounds weights sum to at most 1).  Integer
//     addition is associative: any order, any atomic and any split of the
//     entries across blocks gives the same bits, so a step repeats bit
//     for bit with no float atomic and no sort.  A cotangent with a NaN
//     or an inf gives a d_plane of NaN;
//   d_u[n] = (sum over r of g[n, r] * ((1 - ty) (c10 - c00)
//     + ty (c11 - c01))) * (H - 1) * 0.5, d_v likewise on the other axis,
//     the corner values masked to 0 off the plane (floor, clamp and the
//     mask carry no gradient).
//
// One memset of the counters, then three kernels over coarse plane tiles
// of kTile x kTile texels.  An entry is a (row, tile a corner of the row
// lies in), or a (block, tile) for a block of kRows rows at bit-identical
// coordinates (a regrown model's padding rows), whose sums the second
// kernel takes once for all of them:
//   bin_rows: per row its cell and corners, d_u and d_v, max|g| (an
//     atomicMax on the float's bits, exact in any order), and each tile's
//     entry count, first in a block-wide shared histogram, then one
//     global atomic a tile the block reached: same-address global atomics
//     from many SMs are what a count costs on this card;
//   place_entries: each block scans the tiles' counts in shared memory
//     (block 0 also publishes the layout: offsets, the further chunks of
//     the tiles of more than kChunk entries, their partial slots, and k);
//     per row its tiles again, each entry placed at its tile's next free
//     slot (the order inside a tile is free); a uniform block sums its
//     rows' values for each corner and channel (32-bit warp reductions,
//     exact) into its slot of `pre`.  It also zeroes the partial slots;
//   tile_sums: as many blocks as fit on the card, each looping over the
//     items (tile t's first chunk, then the further chunks), and loading
//     an item's layout, entry and coordinates while the item before it is
//     summed and written.  A tile's int64 sums live in shared memory as
//     two 32-bit words (low, high): the card has no native 64-bit shared
//     atomic add, so each value is a native 32-bit add on the low word,
//     whose returned old value gives the carry, and a 32-bit add of the
//     high word and carry, exact mod 2^64.  A warp whose entries all
//     reach one texel sums them first, one shared add a warp.  A tile of
//     one chunk is written to d_plane once, coalesced, zeros included (no
//     memset of d_plane); the chunks of a larger tile add their nonzero
//     sums into its partial slot with global 64-bit atomics, and the last
//     of them writes the tile.
// place_entries and tile_sums are launched as programmatic dependents:
// each starts its independent part (coordinates, cells, zeroing) while the
// kernel before it finishes.
//
// What bounds it: bytes, d_plane written once, g and the coordinates read
// once, the texels of the rows' cells gathered for d_u and d_v.  What
// holds it above that: the latency of each tile's chain of dependent
// loads (entry, coordinates, cotangent) against the few tiles that the
// shared memory holds at once, and the three launches.
#include <mutex>

#include "plane_sample.cuh"

namespace {

using plane_sample::Cell;
using plane_sample::cell_of;
using plane_sample::corner;
using plane_sample::Corners;
using plane_sample::corners_of;
using plane_sample::kGroup;

constexpr int kRows = 512;              // rows a block of bin / place
constexpr int kTileLog = 5;
constexpr int kTile = 1 << kTileLog;    // tile side, texels
constexpr int kTexels = kTile * kTile;  // texels a tile
constexpr int kSumThreads = 256;        // threads a block of tile_sums
constexpr int kChunk = kSumThreads;     // entries a block: one a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNonFinite = 0x7f800000u;  // bits of +inf
constexpr int kHeader = 8;

// The int32 scratch, in ints from its start.  The header and the three
// counter arrays are zeroed by one memset a call.
enum Header { kMaxBits, kExtra, kExponent };

struct Layout {
  int tiles, tiles_w;
  long long counts, cursor, done;  // [tiles] each, zeroed
  long long offsets;               // [tiles]
  long long split_slot;            // [tiles]: partial slot, or -1
  long long extra;                 // [2 max_extra]: (tile, chunk) pairs
  long long entries;               // [4 n]: rows, or -1 - block, by tile
  long long max_extra, max_splits;
  long long ints;                  // the int32 scratch's size
  long long pre;                   // `pre`'s slots: one a block of rows
};

Layout layout_of(long long n, int h, int w) {
  Layout l;
  const int tiles_h = (h + kTile - 1) / kTile;
  l.tiles_w = (w + kTile - 1) / kTile;
  l.tiles = tiles_h * l.tiles_w;
  // a row's corners lie in at most 4 tiles, so at most 4 n entries; a
  // tile of c > kChunk entries has ceil(c / kChunk) - 1 < c / kChunk
  // extra chunks and a partial slot
  l.max_extra = (4 * n + kChunk - 1) / kChunk;
  l.max_splits = 4 * n / (kChunk + 1);
  l.counts = kHeader;
  l.cursor = l.counts + l.tiles;
  l.done = l.cursor + l.tiles;
  l.offsets = l.done + l.tiles;
  l.split_slot = l.offsets + l.tiles;
  l.extra = l.split_slot + l.tiles;
  l.entries = l.extra + 2 * l.max_extra;
  l.ints = l.entries + 4 * n;
  l.pre = (n + kRows - 1) / kRows;  // 4 r int64 sums a slot
  return l;
}

__host__ __device__ __forceinline__ int chunks_of(int count) {
  return count <= kChunk ? 1 : (count + kChunk - 1) / kChunk;
}

// k of the scale 2^k: max|g| < 2^e (e = -126 below the normal range), n
// <= 2^b, so n * max|g| * 2^k <= 2^62 with k = 62 - b - e; clamped so
// that 2^k and 2^-k are normal float32 values (`grad_exponent` in
// ops/plane_sample.py).
__device__ int grad_exponent(unsigned max_bits, long long n) {
  const int e = (int)(max_bits >> 23) - 126;
  const int b = n > 1 ? 64 - __clzll(n - 1) : 0;
  return min(max(62 - b - e, -126), 126);
}

// Programmatic dependent launch: a kernel launched after another with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while that
// one runs; it waits (griddepcontrol.wait) until that grid has finished
// and its writes are visible before it reads them, and the earlier grid
// lets it be scheduled (griddepcontrol.launch_dependents).
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_grid_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// The tile of each corner that starts a tile's group in the row: key[k]
// is corner k's tile if it is on the plane and no earlier on-plane corner
// of the row shares its tile, else -1.
__device__ __forceinline__ void row_tiles(const Corners& q, int tiles_w,
                                          int key[4]) {
  int t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t[k] = (q.ix[k] >> kTileLog) * tiles_w + (q.iy[k] >> kTileLog);
    bool first = q.inb[k];
#pragma unroll
    for (int j = 0; j < k; ++j) first = first && !(q.inb[j] && t[j] == t[k]);
    key[k] = first ? t[k] : -1;
  }
}

// Whether the block's kRows rows are all live and at bit-identical
// coordinates, so share their cell, weights and corners (every thread
// calls it).
__device__ __forceinline__ bool uniform_block(bool live, float u, float v) {
  __shared__ float s_first[2];
  if (threadIdx.x == 0) {
    s_first[0] = u;
    s_first[1] = v;
  }
  __syncthreads();
  return __syncthreads_and(
      live && __float_as_uint(u) == __float_as_uint(s_first[0]) &&
      __float_as_uint(v) == __float_as_uint(s_first[1]));
}

// The exclusive prefix of x over the block's threads (blockDim.x a
// multiple of 32); `total` gets the block's sum.
__device__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    if (i < warp) before += s_warp[i];
    all += s_warp[i];
  }
  *total = all;
  return before + inc - x;
}

__global__ void __launch_bounds__(kRows)
bin_rows(const float* __restrict__ g, long long sg,
         const float* __restrict__ u, long long su,
         const float* __restrict__ v, long long sv,
         const float* __restrict__ plane, long long n, int r, int h, int w,
         int* __restrict__ s, const Layout l, float* __restrict__ d_u,
         float* __restrict__ d_v, bool count) {
  extern __shared__ int s_hist[];  // [tiles], when counting
  __shared__ unsigned s_max[kRows / 32];
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int lane = threadIdx.x & 31;
  if (count) {
    for (int i = threadIdx.x; i < l.tiles; i += kRows) s_hist[i] = 0;
  }
  unsigned gmax = 0;
  const float cu = live ? u[row * su] : 0.0f, cv = live ? v[row * sv] : 0.0f;
  const Cell c = cell_of(cu, cv, h, w);
  const Corners q = corners_of(c, h, w);
  if (live && d_u != nullptr) {
    int idx[4];
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      idx[k] = q.ix[k] * w + q.iy[k];
      m[k] = q.inb[k] ? 1.0f : 0.0f;
    }
    const long long cells = (long long)h * w;
    float dtx = 0.0f, dty = 0.0f;
    for (int r0 = 0; r0 < r; r0 += kGroup) {
      float t[kGroup][4], gr[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (r0 + j < r) {
          const float* p = plane + (r0 + j) * cells;
#pragma unroll
          for (int k = 0; k < 4; ++k) t[j][k] = p[idx[k]];
          gr[j] = g[row * sg + r0 + j];
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (r0 + j < r) {
          const float c00 = t[j][0] * m[0], c10 = t[j][1] * m[1];
          const float c01 = t[j][2] * m[2], c11 = t[j][3] * m[3];
          dtx = dtx + gr[j] * ((1.0f - c.ty) * (c10 - c00) +
                               c.ty * (c11 - c01));
          dty = dty + gr[j] * ((1.0f - c.tx) * (c01 - c00) +
                               c.tx * (c11 - c10));
          gmax = max(gmax, __float_as_uint(fabsf(gr[j])));
        }
      }
    }
    d_u[row] = (dtx * (float)(h - 1)) * 0.5f;
    d_v[row] = (dty * (float)(w - 1)) * 0.5f;
  } else if (live) {
    for (int ch = 0; ch < r; ++ch)
      gmax = max(gmax, __float_as_uint(fabsf(g[row * sg + ch])));
  }
  if (!count) return;
  let_next_grid_start();

  gmax = __reduce_max_sync(kFull, gmax);
  if (lane == 0) s_max[threadIdx.x >> 5] = gmax;
  int key[4] = {-1, -1, -1, -1};
  if (live) row_tiles(q, l.tiles_w, key);
  // a uniform block is one entry a tile; uniform_block's barriers also
  // order s_hist's zeroing before the adds
  const bool one = uniform_block(live, cu, cv);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned grp =
        one ? (threadIdx.x == 0 ? 1u : 0u) : __match_any_sync(kFull, key[k]);
    if (key[k] >= 0 && grp != 0u && lane == __ffs(grp) - 1)
      atomicAdd(s_hist + key[k], __popc(grp));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < l.tiles; i += kRows)
    if (s_hist[i] != 0) atomicAdd(s + l.counts + i, s_hist[i]);
  if (threadIdx.x == 0) {
    unsigned m = 0;
    for (int i = 0; i < kRows / 32; ++i) m = max(m, s_max[i]);
    atomicMax((unsigned*)s + kMaxBits, m);
  }
}

// Every block: the tiles' entry offsets into shared memory.  Block 0 also
// publishes them, each tile's partial slot (tiles of more than kChunk
// entries), the (tile, chunk) pairs of the chunks after each tile's first,
// and k.  Returns the number of partial slots.
__device__ int lay_out_tiles(int* s, const Layout l, long long n,
                             int* s_off) {
  __shared__ int s_warp[32];
  const int per = (l.tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(l.tiles, (int)threadIdx.x * per);
  const int hi = min(l.tiles, lo + per);
  int cnt = 0, extra = 0, splits = 0;
  for (int t = lo; t < hi; ++t) {
    const int c = s[l.counts + t];
    cnt += c;
    extra += chunks_of(c) - 1;
    splits += c > kChunk;
  }
  int all_extra, all_splits, unused;
  int off = block_exclusive_scan(cnt, s_warp, &unused);
  int ex = block_exclusive_scan(extra, s_warp, &all_extra);
  int split = block_exclusive_scan(splits, s_warp, &all_splits);
  const bool publish = blockIdx.x == 0;
  for (int t = lo; t < hi; ++t) {
    const int c = s[l.counts + t];
    s_off[t] = off;
    off += c;
    if (!publish) continue;
    s[l.offsets + t] = s_off[t];
    s[l.split_slot + t] = c > kChunk ? split++ : -1;
    for (int j = 1; j < chunks_of(c); ++j, ++ex) {
      s[l.extra + 2 * ex] = t;
      s[l.extra + 2 * ex + 1] = j;
    }
  }
  if (publish && threadIdx.x == 0) {
    s[kExtra] = all_extra;
    s[kExponent] = grad_exponent((unsigned)s[kMaxBits], n);
  }
  __syncthreads();
  return all_splits;
}

// The sum of x over the whole warp (every lane calls it), exact mod 2^64:
// x's high word and its low word's two 16-bit halves are each summed by a
// 32-bit reduction that cannot carry out (32 lanes of < 2^16 each), then
// recombined.
__device__ __forceinline__ unsigned long long warp_sum(long long x) {
  const unsigned long long bits = (unsigned long long)x;
  const unsigned lo = (unsigned)bits, hi = (unsigned)(bits >> 32);
  const unsigned a = __reduce_add_sync(kFull, lo >> 16);
  const unsigned b = __reduce_add_sync(kFull, lo & 0xffffu);
  const unsigned c = __reduce_add_sync(kFull, hi);
  return ((unsigned long long)c << 32) + ((unsigned long long)a << 16) + b;
}

__global__ void __launch_bounds__(kRows)
place_entries(const float* __restrict__ g, long long sg,
              const float* __restrict__ u, long long su,
              const float* __restrict__ v, long long sv, long long n,
              int r, int h, int w, int* __restrict__ s, const Layout l,
              unsigned long long* __restrict__ pre,
              unsigned long long* __restrict__ partial) {
  extern __shared__ int s_off[];  // [tiles]
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int lane = threadIdx.x & 31;
  const float cu = live ? u[row * su] : 0.0f, cv = live ? v[row * sv] : 0.0f;
  const Corners q = corners_of(cell_of(cu, cv, h, w), h, w);
  int key[4] = {-1, -1, -1, -1};
  if (live) row_tiles(q, l.tiles_w, key);
  const bool one = uniform_block(live, cu, cv);
  let_next_grid_start();
  wait_for_previous_grid();  // bin_rows' counts and max|g|
  const int splits = lay_out_tiles(s, l, n, s_off);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned grp =
        one ? (threadIdx.x == 0 ? 1u : 0u) : __match_any_sync(kFull, key[k]);
    const int leader = grp == 0u ? 0 : __ffs(grp) - 1;
    int base = 0;
    if (key[k] >= 0 && grp != 0u && lane == leader)
      base = atomicAdd(s + l.cursor + key[k], __popc(grp));
    base = __shfl_sync(kFull, base, leader);
    if (key[k] >= 0 && grp != 0u)
      s[l.entries + s_off[key[k]] + base + __popc(grp & below)] =
          one ? (int)(-1 - (long long)blockIdx.x) : (int)row;
  }
  const unsigned max_bits = (unsigned)s[kMaxBits];
  if (one && max_bits < kNonFinite) {  // the block's sums, once
    __shared__ unsigned long long s_warps[kRows / 32][32];
    const float scale = pow2(grad_exponent(max_bits, n));
    unsigned long long* out = pre + (long long)blockIdx.x * 4 * r;
    for (int r0 = 0; r0 < 4 * r; r0 += 32) {  // (corner, channel) pairs
      for (int p = r0; p < min(4 * r, r0 + 32); ++p) {
        const int k = p / r, ch = p % r;
        const float wk = k == 0 ? q.wgt[0] : k == 1 ? q.wgt[1]
                         : k == 2 ? q.wgt[2] : q.wgt[3];
        const unsigned long long sum =
            warp_sum(__float2ll_rn((g[row * sg + ch] * wk) * scale));
        if (lane == 0) s_warps[threadIdx.x >> 5][p - r0] = sum;
      }
      __syncthreads();
      if ((int)threadIdx.x < min(4 * r - r0, 32)) {
        unsigned long long total = 0;
        for (int i = 0; i < kRows / 32; ++i) total += s_warps[i][threadIdx.x];
        out[r0 + threadIdx.x] = total;
      }
      __syncthreads();
    }
  }
  // the partial slots of the tiles cut into several chunks start at 0
  const long long zeros = (long long)splits * r * kTexels;
  for (long long i = (long long)blockIdx.x * kRows + threadIdx.x; i < zeros;
       i += (long long)gridDim.x * kRows)
    partial[i] = 0ull;
}

// Writes tile (x0, y0) of d_plane [r, h, w], four texels a thread at a
// time (one 16-byte store where w % 4 == 0): value(i) gives the four
// values of texels i .. i + 3 of the tile's [r, kTexels] layout.
template <class Value>
__device__ __forceinline__ void write_tile(float* __restrict__ d_plane,
                                           int r, int h, int w, int x0,
                                           int y0, Value value) {
  const long long cells = (long long)h * w;
  for (int i = 4 * threadIdx.x; i < r * kTexels; i += 4 * blockDim.x) {
    const int ch = i / kTexels, x = x0 + (i % kTexels) / kTile,
              y = y0 + i % kTile;
    if (x >= h || y >= w) continue;
    const float4 f = value(i);
    float* dst = d_plane + ch * cells + (long long)x * w + y;
    if (w % 4 == 0) {
      *(float4*)dst = f;
    } else {
      dst[0] = f.x;
      if (y + 1 < w) dst[1] = f.y;
      if (y + 2 < w) dst[2] = f.z;
      if (y + 3 < w) dst[3] = f.w;
    }
  }
}

// acc[i] += x mod 2^64, acc a [2, r * kTexels] array of 32-bit words (low,
// high): the low word's returned old value gives the carry.
__device__ __forceinline__ void acc_add(unsigned* acc, int stride, int i,
                                        unsigned long long x) {
  const unsigned lo = (unsigned)x;
  const unsigned old = atomicAdd(acc + i, lo);
  const unsigned hi = (unsigned)(x >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(acc + stride + i, hi);
}

// One item of tile_sums: a chunk of a tile's entries, and the entry this
// thread takes from it.
struct Item {
  int t, j, count, end;
  int entry;     // a row, or -1 - block; meaningful when i < end
  int i;         // this thread's index into the entries
  float cu, cv;  // the entry's (first) row's coordinates
};

__device__ __forceinline__ void item_meta(const int* __restrict__ s,
                                          const Layout& l, int item,
                                          Item* it) {
  it->t = item;
  it->j = 0;
  if (item >= l.tiles) {  // a further chunk of a tile of many entries
    it->t = s[l.extra + 2 * (item - l.tiles)];
    it->j = s[l.extra + 2 * (item - l.tiles) + 1];
  }
  it->count = s[l.counts + it->t];
  const int off = s[l.offsets + it->t];
  it->i = off + it->j * kChunk + threadIdx.x;
  it->end = off + min(it->count, (it->j + 1) * kChunk);
}

__device__ __forceinline__ long long item_row(const Item& it) {
  return it.i >= it.end ? -1
         : it.entry < 0 ? (long long)kRows * (-1 - it.entry)
                        : it.entry;
}

// The item's row's coordinates (a block entry's first row's).
__device__ __forceinline__ void item_coords(const float* __restrict__ u,
                                            long long su,
                                            const float* __restrict__ v,
                                            long long sv, Item* it) {
  const long long row = item_row(*it);
  it->cu = row >= 0 ? u[row * su] : 0.0f;
  it->cv = row >= 0 ? v[row * sv] : 0.0f;
}

__global__ void __launch_bounds__(kSumThreads)
tile_sums(const float* __restrict__ g, long long sg,
          const float* __restrict__ u, long long su,
          const float* __restrict__ v, long long sv, int r, int h, int w,
          const int* __restrict__ s, const Layout l,
          const unsigned long long* __restrict__ pre,
          unsigned long long* __restrict__ partial,
          unsigned* __restrict__ done, float* __restrict__ d_plane) {
  extern __shared__ unsigned acc[];  // [2, r, kTexels]: low, high words
  __shared__ bool s_last;
  const int stride = r * kTexels;
  const int lane = threadIdx.x & 31;
  for (int i = 4 * threadIdx.x; i < 2 * stride; i += 4 * kSumThreads)
    *(uint4*)(acc + i) = make_uint4(0u, 0u, 0u, 0u);
  wait_for_previous_grid();  // place_entries' entries and layout
  const unsigned max_bits = (unsigned)s[kMaxBits];
  const int k2 = s[kExponent];
  const float scale = pow2(k2), unscale = pow2(-k2);
  const int items = l.tiles + s[kExtra];
  // the block's items: blockIdx.x, + gridDim.x, ...  Each item's loads
  // (its layout, this thread's entry, the entry's coordinates) are issued
  // while the item before it is summed and written.
  Item nx{};
  if (blockIdx.x < items) {
    item_meta(s, l, blockIdx.x, &nx);
    nx.entry = nx.i < nx.end ? s[l.entries + nx.i] : 0;
    item_coords(u, su, v, sv, &nx);
  }
  __syncthreads();
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = nx;
    const bool more = item + (int)gridDim.x < items;
    if (more) item_meta(s, l, item + (int)gridDim.x, &nx);
    const int x0 = (it.t / l.tiles_w) * kTile, y0 = (it.t % l.tiles_w) * kTile;
    if (max_bits >= kNonFinite || it.count == 0) {  // NaN or inf in g; empty
      const float f =
          max_bits >= kNonFinite ? __int_as_float(0x7fc00000) : 0.0f;
      if (it.j == 0)
        write_tile(d_plane, r, h, w, x0, y0,
                   [=](int) { return make_float4(f, f, f, f); });
      if (more) {
        nx.entry = nx.i < nx.end ? s[l.entries + nx.i] : 0;
        item_coords(u, su, v, sv, &nx);
      }
      continue;
    }
    const bool whole = it.i < it.end && it.entry < 0;  // a uniform block's
    const long long row = item_row(it);
    const unsigned long long* sums =
        whole ? pre + (long long)(-1 - it.entry) * 4 * r : pre;
    float wgt[4];
    int key[4];
    const Cell c = cell_of(it.cu, it.cv, h, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bool inb;
      int ix, iy;
      wgt[k] = corner(c, k, h, w, &inb, &ix, &iy);
      const bool here = row >= 0 && inb && ix >= x0 && ix < x0 + kTile &&
                        iy >= y0 && iy < y0 + kTile;
      key[k] = here ? (ix - x0) * kTile + (iy - y0) : -1;
    }
    bool one[4];  // every lane of the warp at this corner's texel
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int k0 = __shfl_sync(kFull, key[k], 0);
      one[k] = __all_sync(kFull, key[k] == k0 && k0 >= 0);
    }
    // channel ch's value at each corner into the tile's sums
    const auto add = [&](int ch, float gr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long x = whole ? (long long)sums[k * r + ch]
                                  : __float2ll_rn((gr * wgt[k]) * scale);
        if (one[k]) {
          const unsigned long long sum = warp_sum(x);
          if (lane == 0) acc_add(acc, stride, ch * kTexels + key[k], sum);
        } else if (key[k] >= 0) {
          acc_add(acc, stride, ch * kTexels + key[k], (unsigned long long)x);
        }
      }
    };
    for (int ch = 0; ch < r; ++ch)
      add(ch, row >= 0 && !whole ? g[row * sg + ch] : 0.0f);
    if (more) nx.entry = nx.i < nx.end ? s[l.entries + nx.i] : 0;
    __syncthreads();
    if (more) item_coords(u, su, v, sv, &nx);

    unsigned* a = acc;
    if (chunks_of(it.count) > 1) {  // add into the tile's partial slot
      unsigned long long* slot =
          partial + (long long)s[l.split_slot + it.t] * stride;
      for (int i = threadIdx.x; i < stride; i += kSumThreads) {
        const unsigned long long x =
            ((unsigned long long)a[stride + i] << 32) + a[i];
        a[i] = a[stride + i] = 0u;
        if (x != 0ull) atomicAdd(slot + i, x);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last =
            atomicAdd(done + it.t, 1u) == (unsigned)chunks_of(it.count) - 1;
      __syncthreads();
      if (s_last) {  // the tile's last chunk: write it
        __threadfence();
        write_tile(d_plane, r, h, w, x0, y0, [=](int i) {
          const long long* p = (const long long*)slot + i;
          return make_float4(__ll2float_rn(__ldcg(p)) * unscale,
                             __ll2float_rn(__ldcg(p + 1)) * unscale,
                             __ll2float_rn(__ldcg(p + 2)) * unscale,
                             __ll2float_rn(__ldcg(p + 3)) * unscale);
        });
      }
      continue;
    }
    write_tile(d_plane, r, h, w, x0, y0, [=](int i) {
      const uint4 lo = *(const uint4*)(a + i);
      const uint4 hi = *(const uint4*)(a + stride + i);
      *(uint4*)(a + i) = *(uint4*)(a + stride + i) =
          make_uint4(0u, 0u, 0u, 0u);
      const auto f = [=](unsigned x, unsigned y) {
        return __ll2float_rn((long long)(((unsigned long long)y << 32) + x)) *
               unscale;
      };
      return make_float4(f(lo.x, hi.x), f(lo.y, hi.y), f(lo.z, hi.z),
                         f(lo.w, hi.w));
    });
    __syncthreads();  // acc zero again before the next item's adds
  }
}

// The blocks of tile_sums with `smem` bytes of shared memory that the
// current device holds at once (asked once, then kept for that device and
// size).
cudaError_t resident_blocks(int smem, int* blocks) {
  static std::mutex lock;
  static int known_device = -1, known_smem = -1, known_blocks = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (device != known_device || smem != known_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_sums,
                                                          kSumThreads, smem);
    if (err != cudaSuccess) return err;
    known_device = device;
    known_smem = smem;
    known_blocks = sms * per_sm;
  }
  *blocks = known_blocks;
  return cudaSuccess;
}

}  // namespace

// Sizes of the backward's scratch for n rows of an h x w plane with r
// channels: out[0] int32 elements, out[1] int64 elements.
extern "C" void plane_sample_bwd_scratch(long long n, int r, int h, int w,
                                         long long* out) {
  const Layout l = layout_of(n, h, w);
  out[0] = l.ints;
  out[1] = (l.pre * 4 + l.max_splits * kTexels) * r;
}

// g: [n, r] float32, row stride sg, channels contiguous; u, v: [n]
// float32 with element strides su, sv; plane: [r, h, w] float32,
// contiguous.  With d_plane given ([r, h, w], written whole): `ints` and
// `wide`, scratch of the sizes plane_sample_bwd_scratch gives.  With d_u
// given, d_u and d_v [n] float32.  Launches on `stream` and returns the
// first CUDA error.
extern "C" int plane_sample_bwd(const float* g, long long sg, const float* u,
                                long long su, const float* v, long long sv,
                                const float* plane, long long n, int r, int h,
                                int w, int* ints, unsigned long long* wide,
                                float* d_plane, float* d_u, float* d_v,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Layout l = layout_of(n, h, w);
  const bool count = d_plane != nullptr;
  const unsigned rows_grid = (unsigned)max(1LL, (n + kRows - 1) / kRows);
  if (!count) {
    if (d_u != nullptr && n > 0)
      bin_rows<<<rows_grid, kRows, 0, st>>>(g, sg, u, su, v, sv, plane, n, r,
                                            h, w, ints, l, d_u, d_v, false);
    return (int)cudaGetLastError();
  }
  unsigned long long* pre = wide;
  unsigned long long* partial = wide + l.pre * 4 * r;
  // the tiles' table in the row passes' shared memory, and the tile's
  // sums in tile_sums'; above 48 KiB a kernel must ask for it
  const int table = (int)sizeof(int) * l.tiles;
  const int sums = (int)sizeof(unsigned) * 2 * r * kTexels;
  cudaError_t err = cudaSuccess;
  if (table > 48 * 1024) {
    err = cudaFuncSetAttribute(
        bin_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, table);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          place_entries, cudaFuncAttributeMaxDynamicSharedMemorySize, table);
  }
  if (err == cudaSuccess && sums > 48 * 1024)
    err = cudaFuncSetAttribute(
        tile_sums, cudaFuncAttributeMaxDynamicSharedMemorySize, sums);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(ints, 0, sizeof(int) * l.offsets, st);
  if (err != cudaSuccess) return (int)err;
  bin_rows<<<rows_grid, kRows, table, st>>>(g, sg, u, su, v, sv, plane, n, r,
                                            h, w, ints, l, d_u, d_v, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // place_entries and tile_sums start while the kernel before them runs
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows_grid);
  cfg.blockDim = dim3(kRows);
  cfg.dynamicSmemBytes = table;
  cfg.stream = st;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, place_entries, g, sg, u, su, v, sv, n, r, h,
                           w, ints, l, pre, partial);
  if (err != cudaSuccess) return (int)err;
  // tile_sums runs as many blocks as fit on the card at once, each
  // looping over the items
  int resident = 0;
  if ((err = resident_blocks(sums, &resident)) != cudaSuccess)
    return (int)err;
  const long long grid =
      min(l.tiles + l.max_extra, (long long)max(1, resident));
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kSumThreads);
  cfg.dynamicSmemBytes = sums;
  return (int)cudaLaunchKernelEx(
      &cfg, tile_sums, g, sg, u, su, v, sv, r, h, w, (const int*)ints, l,
      (const unsigned long long*)pre, partial, (unsigned*)ints + l.done,
      d_plane);
}
