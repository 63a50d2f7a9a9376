// Tile binning, pass 1 of 3: the pairs each tile receives, their offsets,
// and the binning's counters.
//
// Replaces the counting half of the XLA binning of splatco_tpu/ops/
// binning.py:210 `bin_gaussians` and splatco_tpu/ops/raster_v3.py
// `bin_gaussians_v3` (see binning.cuh).  Computes what `bin_count_plain`
// (splatco_torch/ops/binning.py) computes: per tile the number of
// reach-valid (tile, gaussian) slots, tile_start / tile_end as the
// exclusive / inclusive scan of those counts (int32), and stats (int64):
// num_clipped, max_slots (the most valid slots of one gaussian), the pair
// count P and the longest segment.  The wrapper reads P and the longest
// segment back: the binning's one host sync.
//
// What bounds it: operations, the reach test of every slot of the clipped
// rects (a few dozen float operations each), and the counters: same-address
// global atomics from many SMs are slow, so one thread a gaussian counts
// into a per-block histogram of the tiles in shared memory, and each block
// adds its non-zero counts to the global ones.  The last block to finish
// (a ticket taken after a fence) scans the counts, one pass over <= a few
// thousand tiles, instead of a second launch.
#include "binning.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
count_slots(binning::Columns c, binning::Grid g, int* __restrict__ counts,
            int* __restrict__ misc, int* __restrict__ tile_start,
            int* __restrict__ tile_end, long long* __restrict__ stats) {
  extern __shared__ int s_count[];  // [num_tiles] when kShared
  __shared__ int s_clipped, s_max, s_longest;
  __shared__ long long s_sum[kThreads];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  if (kShared) {
    for (int t = tid; t < g.num_tiles; t += kThreads) s_count[t] = 0;
  }
  if (tid == 0) {
    s_clipped = 0;
    s_max = 0;
    s_longest = 0;
  }
  __syncthreads();
  const long long n = (long long)blockIdx.x * kThreads + tid;
  if (n < c.n) {
    bool clipped;
    const int valid = binning::visit_gaussian(
        c, n, g, &clipped, [&](int tile, int) {
          atomicAdd(kShared ? &s_count[tile] : &counts[tile], 1);
        });
    if (clipped) atomicAdd(&s_clipped, 1);
    if (valid) atomicMax(&s_max, valid);
  }
  __syncthreads();
  if (kShared) {
    for (int t = tid; t < g.num_tiles; t += kThreads) {
      const int k = s_count[t];
      if (k) atomicAdd(&counts[t], k);
    }
  }
  if (tid == 0) {
    if (s_clipped) atomicAdd(&misc[0], s_clipped);
    if (s_max) atomicMax(&misc[1], s_max);
  }
  // the last block to arrive scans the counts
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&misc[2], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int per = (g.num_tiles + kThreads - 1) / kThreads;
  const int lo = min(tid * per, g.num_tiles);
  const int hi = min(lo + per, g.num_tiles);
  long long sum = 0;
  int longest = 0;
  for (int t = lo; t < hi; ++t) {
    const int k = __ldcg(&counts[t]);
    sum += k;
    longest = max(longest, k);
  }
  s_sum[tid] = sum;
  if (longest) atomicMax(&s_longest, longest);
  __syncthreads();
  if (tid == 0) {
    long long run = 0;
    for (int i = 0; i < kThreads; ++i) {
      const long long v = s_sum[i];
      s_sum[i] = run;
      run += v;
    }
    stats[0] = __ldcg(&misc[0]);
    stats[1] = __ldcg(&misc[1]);
    stats[2] = run;
  }
  __syncthreads();
  long long run = s_sum[tid];
  for (int t = lo; t < hi; ++t) {
    tile_start[t] = (int)run;
    run += __ldcg(&counts[t]);
    tile_end[t] = (int)run;
  }
  if (tid == 0) stats[3] = s_longest;
}

}  // namespace

// mx, my, ca, cb, cc, op, radius: [n] float32, contiguous.  scratch: [4 +
// num_tiles] int32, zeroed: the clipped count, max_slots, the blocks done
// and one unused, then the per-tile counts.
// tile_start, tile_end: [num_tiles] int32; stats: [4] int64 (num_clipped,
// max_slots, pairs, longest segment).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bin_count(const float* mx, const float* my, const float* ca,
                         const float* cb, const float* cc, const float* op,
                         const float* radius, long long n, int tile,
                         int tiles_x, int tiles_y, int kmax, int parent_major,
                         int* scratch, int* tile_start, int* tile_end,
                         long long* stats, void* stream) {
  const binning::Columns c{mx, my, ca, cb, cc, op, radius, n};
  const binning::Grid g{tile, tiles_x, tiles_y, tiles_x * tiles_y, kmax,
                        parent_major != 0};
  int* misc = scratch;
  int* counts = scratch + 4;
  const unsigned blocks =
      n > 0 ? (unsigned)((n + kThreads - 1) / kThreads) : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (g.num_tiles <= binning::kSharedTiles) {
    count_slots<true><<<blocks, kThreads, sizeof(int) * g.num_tiles, s>>>(
        c, g, counts, misc, tile_start, tile_end, stats);
  } else {
    count_slots<false><<<blocks, kThreads, 0, s>>>(c, g, counts, misc,
                                                   tile_start, tile_end,
                                                   stats);
  }
  return (int)cudaGetLastError();
}
