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
// tests, recomputed here rather than kept from bin_count.  A hot tile's
// cursor is one address that every SM would add to, so a block first
// counts its slots per tile in shared memory, reserves each tile's run with
// one global atomic, and then hands out positions from shared memory.
#include "binning.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
place_keys(binning::Columns c, binning::Grid g,
           const float* __restrict__ depth,
           const int* __restrict__ tile_start, int* __restrict__ cursor,
           unsigned long long* __restrict__ keys) {
  extern __shared__ int s_pos[];  // [num_tiles] when kShared
  const int tid = threadIdx.x;
  const long long n = (long long)blockIdx.x * kThreads + tid;
  const bool mine = n < c.n;
  bool clipped;
  if (kShared) {
    for (int t = tid; t < g.num_tiles; t += kThreads) s_pos[t] = 0;
    __syncthreads();
    if (mine) {
      binning::visit_gaussian(c, n, g, &clipped, [&](int tile, int) {
        atomicAdd(&s_pos[tile], 1);
      });
    }
    __syncthreads();
    for (int t = tid; t < g.num_tiles; t += kThreads) {
      const int k = s_pos[t];
      if (k) s_pos[t] = tile_start[t] + atomicAdd(&cursor[t], k);
    }
    __syncthreads();
  }
  if (!mine) return;
  const unsigned long long hi =
      (unsigned long long)__float_as_uint(depth[n]) << 32;
  binning::visit_gaussian(c, n, g, &clipped, [&](int tile, int rank) {
    const int pos = kShared ? atomicAdd(&s_pos[tile], 1)
                            : tile_start[tile] + atomicAdd(&cursor[tile], 1);
    keys[pos] = hi | (unsigned long long)((long long)rank * c.n + n);
  });
}

}  // namespace

// mx, my, ca, cb, cc, op, radius, depth: [n] float32, contiguous;
// tile_start: [num_tiles] int32 (bin_count's); cursor: [num_tiles] int32,
// zeroed; keys: [pairs] uint64.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bin_place(const float* mx, const float* my, const float* ca,
                         const float* cb, const float* cc, const float* op,
                         const float* radius, const float* depth, long long n,
                         int tile, int tiles_x, int tiles_y, int kmax,
                         int parent_major, const int* tile_start, int* cursor,
                         unsigned long long* keys, void* stream) {
  const binning::Columns c{mx, my, ca, cb, cc, op, radius, n};
  const binning::Grid g{tile, tiles_x, tiles_y, tiles_x * tiles_y, kmax,
                        parent_major != 0};
  const unsigned blocks =
      n > 0 ? (unsigned)((n + kThreads - 1) / kThreads) : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (g.num_tiles <= binning::kSharedTiles) {
    place_keys<true><<<blocks, kThreads, sizeof(int) * g.num_tiles, s>>>(
        c, g, depth, tile_start, cursor, keys);
  } else {
    place_keys<false><<<blocks, kThreads, 0, s>>>(c, g, depth, tile_start,
                                                  cursor, keys);
  }
  return (int)cudaGetLastError();
}
