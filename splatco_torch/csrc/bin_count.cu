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
// rects (a few dozen float operations each), and the counters.  The
// design:
//   - persistent blocks, at most kBlocksPerSm an SM: each zeroes
//     a histogram of every tile in shared memory once, its warps take 32
//     rows at a time (a block's warps consecutive chunks, the blocks in
//     turn), and it adds its non-zero counts to the global ones once, so
//     the zeroing, the flush and the ticket are paid once a block, not
//     once every 256 rows;
//   - slot-parallel warps (binning::warp_slots): a warp's lanes share its
//     rows' slots, so a warp does not wait for its widest rect and rows of
//     radius 0 cost one load;
//   - each valid slot adds one to its tile's shared counter: the lanes of
//     a round that hit one tile are not combined first (__match_any_sync
//     there cost 4-8 % on the frames and gained nothing on a hot tile,
//     PERF.md); in global memory they are, one atomic a group;
//   - the last block to finish (a ticket taken after a fence) scans the
//     counts with warp shuffles, a warp a contiguous range of tiles.
// Above binning::kSharedTiles tiles the slots count straight into the
// global counters (no histogram).
#include <algorithm>

#include "binning.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// persistent blocks resident on one SM, at most
constexpr int kBlocksPerSm = 2;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(binning::kFull, v, d);
  return v;
}

template <bool kShared, bool kParentMajor>
__global__ void __launch_bounds__(kThreads)
count_slots(binning::Columns c, binning::Grid g, long long chunks,
            int* __restrict__ counts, int* __restrict__ misc,
            int* __restrict__ tile_start, int* __restrict__ tile_end,
            long long* __restrict__ stats) {
  extern __shared__ int s_count[];  // [num_tiles] when kShared
  __shared__ int s_clipped, s_max;
  __shared__ long long s_sum[kWarps];
  __shared__ int s_longest[kWarps];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kShared) {
    for (int t = tid; t < g.num_tiles; t += kThreads) s_count[t] = 0;
  }
  if (tid == 0) {
    s_clipped = 0;
    s_max = 0;
  }
  __syncthreads();
  for (long long k = (long long)blockIdx.x * kWarps + warp; k < chunks;
       k += (long long)gridDim.x * kWarps) {
    unsigned unused;
    int clipped;
    const int valid = binning::warp_slots<kParentMajor>(
        c, g, k * binning::kWarpRows, nullptr, &unused, &clipped,
        [&](const binning::Slot& s) {
          if (kShared) {
            if (s.valid) atomicAdd(&s_count[s.tile], 1);
          } else {
            const binning::Group grp = binning::group_of(s.tile);
            if (s.valid && grp.rank == 0)
              atomicAdd(&counts[s.tile], __popc(grp.lanes));
          }
        });
    const int most = __reduce_max_sync(binning::kFull, valid);
    if (lane == 0) {
      if (clipped) atomicAdd(&s_clipped, clipped);
      if (most) atomicMax(&s_max, most);
    }
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
  // the counts, staged in the histogram's shared memory where they fit
  if (kShared) {
#pragma unroll 4
    for (int t = tid; t < g.num_tiles; t += kThreads)
      s_count[t] = __ldcg(&counts[t]);
    __syncthreads();
  }
  auto count_of = [&](int t) {
    return kShared ? s_count[t] : __ldcg(&counts[t]);
  };
  // a warp a contiguous range of tiles, a multiple of 32 long
  const int per = ((g.num_tiles + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(warp * per, g.num_tiles);
  const int hi = min(lo + per, g.num_tiles);
  long long sum = 0;
  int longest = 0;
  for (int t = lo + lane; t < hi; t += 32) {
    const int k = count_of(t);
    sum += k;
    longest = max(longest, k);
  }
  sum = warp_sum(sum);
  longest = __reduce_max_sync(binning::kFull, longest);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_longest[warp] = longest;
  }
  __syncthreads();
  if (warp == 0) {
    const long long v = lane < kWarps ? s_sum[lane] : 0;
    long long incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(binning::kFull, incl, d);
      if (lane >= d) incl += u;
    }
    const int most = __reduce_max_sync(binning::kFull,
                                       lane < kWarps ? s_longest[lane] : 0);
    if (lane < kWarps) s_sum[lane] = incl - v;
    if (lane == 31) {
      stats[0] = __ldcg(&misc[0]);
      stats[1] = __ldcg(&misc[1]);
      stats[2] = incl;
      stats[3] = most;
    }
  }
  __syncthreads();
  // P < 2^31 (the wrappers keep kmax * N below it): int32 offsets
  int run = (int)s_sum[warp];
  for (int t0 = lo; t0 < hi; t0 += 32) {
    const int t = t0 + lane;
    const int k = t < hi ? count_of(t) : 0;
    int incl = k;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(binning::kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (t < hi) {
      tile_start[t] = run + incl - k;
      tile_end[t] = run + incl;
    }
    run += __shfl_sync(binning::kFull, incl, 31);
  }
}

// Persistent blocks for `chunks` warp chunks: as many as the card holds
// resident (at most kBlocksPerSm an SM), no more than the chunks need,
// at least one (the scan).
template <class K>
int persistent_blocks(K kernel, size_t smem, long long chunks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const long long want = (chunks + kWarps - 1) / kWarps;
  const long long most =
      (long long)sms * std::max(std::min(per_sm, kBlocksPerSm), 1);
  return (int)std::max(std::min(want, most), 1LL);
}

}  // namespace

// mx, my, ca, cb, cc, op, radius: [n] float32, contiguous.  scratch: [4 +
// num_tiles] int32, zeroed: the clipped count, max_slots, the blocks done
// and one unused, then the per-tile counts.
// tile_start, tile_end: [num_tiles] int32; stats: [4] int64 (num_clipped,
// max_slots, pairs, longest segment).  Launches on `stream` and returns
// the first CUDA error.
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
  const long long chunks =
      (n + binning::kWarpRows - 1) / binning::kWarpRows;
  const bool shared = g.num_tiles <= binning::kSharedTiles;
  const size_t smem = shared ? sizeof(int) * g.num_tiles : 0;
  auto kernel = shared ? (g.parent_major ? count_slots<true, true>
                                         : count_slots<true, false>)
                       : (g.parent_major ? count_slots<false, true>
                                         : count_slots<false, false>);
  if (shared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<persistent_blocks(kernel, smem, chunks), kThreads, smem,
           (cudaStream_t)stream>>>(c, g, chunks, counts, misc, tile_start,
                                   tile_end, stats);
  return (int)cudaGetLastError();
}
