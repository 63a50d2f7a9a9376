// Tile binning, pass 2 of 3: each (tile, gaussian) pair's sort key,
// placed in its tile's segment.
//
// Replaces the emission of the XLA binning of splatco_tpu/ops/binning.py:210
// `bin_gaussians` and splatco_tpu/ops/raster_v3.py `bin_gaussians_v3` (see
// binning.cuh).  Computes what `bin_place_plain` (splatco_torch/ops/
// binning.py) computes, up to the order within a segment: for each
// reach-valid slot of rank j of gaussian n in tile t, the key
// float_bits(depth[n]) << 32 | (j * N + n) at some position of
// [tile_start[t], tile_end[t]).  Which position a key takes depends on the
// atomics' order; bin_sort_tiles sorts each segment, and the keys are
// unique, so nothing after it does.
//
// What bounds it: the keys written (8 bytes a pair) and the slots' reach
// tests, recomputed here rather than kept from bin_count.  Each gaussian
// is visited once, by slot-parallel warps (binning::warp_slots, as in
// bin_count.cu), a warp 32 rows; in each round of 32 slots the lanes that
// hit one tile reserve their run of the tile's cursor with one global
// atomic made by the group's leader (__match_any_sync); a lane's key
// takes the position of its rank in the group, so a group's keys are
// written side by side.  With no per-block state the blocks are not
// persistent: the hardware hands a block's 8 warps their rows as SMs
// free up, which balances uneven rows better (PERF.md).
#include <algorithm>

#include "binning.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kParentMajor>
__global__ void __launch_bounds__(kThreads)
place_keys(binning::Columns c, binning::Grid g, long long chunks,
           const float* __restrict__ depth,
           const int* __restrict__ tile_start, int* __restrict__ cursor,
           unsigned long long* __restrict__ keys) {
  const long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= chunks) return;  // a whole warp
  const long long row0 = k * binning::kWarpRows;
  unsigned bits;
  int clipped;
  binning::warp_slots<kParentMajor>(
      c, g, row0, depth, &bits, &clipped, [&](const binning::Slot& s) {
        const unsigned hi = __shfl_sync(binning::kFull, bits, s.owner);
        const binning::Group grp = binning::group_of(s.tile);
        int pos = 0;
        if (s.valid && grp.rank == 0)
          pos = tile_start[s.tile] +
                atomicAdd(&cursor[s.tile], __popc(grp.lanes));
        pos = __shfl_sync(binning::kFull, pos, grp.leader) + grp.rank;
        if (s.valid)
          keys[pos] = (unsigned long long)hi << 32 |
                      (unsigned long long)((long long)s.rank * c.n + row0 +
                                           s.row);
      });
}

}  // namespace

// mx, my, ca, cb, cc, op, radius, depth: [n] float32, contiguous;
// tile_start: [num_tiles] int32 (bin_count's); cursor: [num_tiles] int32,
// zeroed; keys: [pairs] uint64.  Launches on `stream` and returns
// cudaGetLastError().  One path for every grid: the cursors are global
// (no per-block histogram), so only bin_count forks on the tile count.
extern "C" int bin_place(const float* mx, const float* my, const float* ca,
                         const float* cb, const float* cc, const float* op,
                         const float* radius, const float* depth, long long n,
                         int tile, int tiles_x, int tiles_y, int kmax,
                         int parent_major, const int* tile_start, int* cursor,
                         unsigned long long* keys, void* stream) {
  const binning::Columns c{mx, my, ca, cb, cc, op, radius, n};
  const binning::Grid g{tile, tiles_x, tiles_y, tiles_x * tiles_y, kmax,
                        parent_major != 0};
  const long long chunks =
      (n + binning::kWarpRows - 1) / binning::kWarpRows;
  const long long blocks = std::max((chunks + kWarps - 1) / kWarps, 1LL);
  auto kernel = g.parent_major ? place_keys<true> : place_keys<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      c, g, chunks, depth, tile_start, cursor, keys);
  return (int)cudaGetLastError();
}
