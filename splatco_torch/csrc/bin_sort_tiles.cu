// Tile binning, pass 3 of 3: each tile's keys sorted, and the records, the
// gaussian ids, the slot map and the slot mask written from them.
//
// Replaces the `jax.lax.sort`s and gathers of the XLA binning of
// splatco_tpu/ops/binning.py:210 `bin_gaussians` (:277, :300) and
// splatco_tpu/ops/raster_v3.py `bin_gaussians_v3` (see binning.cuh).
// Computes what `bin_sort_tiles_plain` (splatco_torch/ops/binning.py)
// computes: each segment [tile_start, tile_end) of `keys` sorted ascending
// (the keys of a tile are unique, so the result does not depend on the
// order bin_place left them in), and for the key at position p, with low
// word e = j * N + n: gauss_id[p] = n, records[:, p] = gaussian n's nine
// columns (mx, my, ca, cb, cc, op, r, g, b), slot_pos[n, j] = p and bit
// j % 32 of slot_mask[j / 32, n] set.  The map is written only where the
// mask is set: nothing of kmax * N is filled, only the mask (4 B a
// gaussian a word) is zeroed, on the stream, and each bit is set with an
// integer atomicOr, whose order does not matter.
//
// What bounds it: bytes, the keys read, the 36 B record and 8 B id written
// a pair, 4 B of map a pair, the mask.  A block a tile sorts a segment of
// up to kChunk keys in shared memory and writes its pairs directly.  The
// sort is a bitonic network over the next power of two whose stages are
// taken up to three at a time: a thread holds the 8 keys they join in
// registers, so a barrier and a round trip through shared memory serve
// three stages (30 passes for 4,096 keys, where one a stage took 78, each
// pair's index found by an integer division), and a pad word after every
// 8 keys in shared memory keeps a warp's loads on distinct banks.  The
// shared memory is sized from the longest segment (at most kChunk keys)
// and the block from it too, a thread a group of 8 keys but at least
// kMinThreads, so a frame of short segments keeps more blocks on an SM.
// Writing the pairs costs more than the network on real frames, the
// map's scattered entries most of it (packing the gaussians' columns
// before the gathers, and a j-major map, measured slower there: PERF.md).
// A longer segment (a tile near the camera, or one many gaussians cover)
// is listed by the first pass; a second kernel, over the listed tiles
// only (at most pairs / (kChunk + 1)), sorts their chunks of kChunk keys
// in parallel, and rounds of a merge then join the sorted chunks two by
// two, O(L) a round and log2(L / kChunk) rounds for a segment of L keys
// (chunks of 16,384 keys in 128 KiB of shared memory, two rounds fewer
// for 30,000 keys, measured twice as slow: a bigger network on one SM,
// PERF.md).  A merging block makes
// kMergeTile keys: two warps find its slices of the two runs (32 probes a
// step, so a few dependent loads where a binary search took one a key
// bit), the block stages them in shared memory and each thread merges
// kMergeKeys there.  The last round writes the pairs.  The host launches
// the long path only when bin_count's longest segment needs it.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;   // keys a sorting block sorts
constexpr int kThreads = 512;  // threads a sorting block (kChunk / 8), at most
constexpr int kMinThreads = 256;  // and at least
constexpr int kMergeThreads = 256;
constexpr int kMergeKeys = 8;  // merged keys a thread makes
constexpr int kMergeTile = kMergeThreads * kMergeKeys;  // a block's
constexpr unsigned long long kPad = ~0ULL;  // above every key

struct Out {
  const float *mx, *my, *ca, *cb, *cc, *op, *colors;  // colors [n, 3]
  unsigned n;            // gaussians (kmax * n < 2^31)
  int kmax;
  long long pairs;
  float* records;        // [9, pairs]
  long long* gauss_id;   // [pairs]
  int* slot_pos;         // [n, kmax], written under the mask only
  unsigned* slot_mask;   // [ceil(kmax / 32), n], zeroed
};

__device__ __forceinline__ void write_pair(const Out& o,
                                           unsigned long long key,
                                           long long pos) {
  const unsigned e = (unsigned)key;  // j * n + g < 2^31: 32-bit division
  const unsigned j = e / o.n;
  const long long g = e - j * o.n;
  o.gauss_id[pos] = g;
  float* r = o.records + pos;
  r[0] = o.mx[g];
  r[o.pairs] = o.my[g];
  r[2 * o.pairs] = o.ca[g];
  r[3 * o.pairs] = o.cb[g];
  r[4 * o.pairs] = o.cc[g];
  r[5 * o.pairs] = o.op[g];
  r[6 * o.pairs] = o.colors[3 * g];
  r[7 * o.pairs] = o.colors[3 * g + 1];
  r[8 * o.pairs] = o.colors[3 * g + 2];
  o.slot_pos[(long long)g * o.kmax + j] = (int)pos;
  atomicOr(o.slot_mask + (long long)(j >> 5) * o.n + g, 1u << (j & 31));
}

__device__ __forceinline__ void order(unsigned long long& a,
                                      unsigned long long& b, bool up) {
  if ((a > b) == up) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// Shared-memory index of key i: a pad word after every 8 keys, so that
// 8 contiguous keys of a thread lie on distinct banks across a warp.
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// R consecutive stages j, j / 2, ..., j >> (R - 1) of the bitonic merge of
// blocks of k keys, over s[0, m2): a thread loads the 2^R keys that the
// stages join (indices base + t * low, low = j >> (R - 1)) into registers,
// runs the R * 2^(R-1) compare-exchanges and stores them back.
template <int R>
__device__ __forceinline__ void bitonic_pass(unsigned long long* s, int m2,
                                             int k, int j) {
  constexpr int kKeys = 1 << R;
  const int low = j >> (R - 1);
  for (int q = threadIdx.x; q < (m2 >> R); q += blockDim.x) {
    const int below = q & (low - 1);
    const int base = ((q - below) << R) | below;  // R zero bits inserted
    unsigned long long v[kKeys];
#pragma unroll
    for (int t = 0; t < kKeys; ++t) v[t] = s[pad(base + t * low)];
    const bool up = (base & k) == 0;  // the same for every key of the group
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int t = 0; t < kKeys; ++t) {
        if (!(t & (1 << r))) order(v[t], v[t | (1 << r)], up);
      }
    }
#pragma unroll
    for (int t = 0; t < kKeys; ++t) s[pad(base + t * low)] = v[t];
  }
  __syncthreads();
}

// Sorts keys [0, m2) of s (at pad(i)) ascending, m2 a power of two, with
// the whole block: the network's stages of stride 32 and more three to a
// pass, then those of stride 16 and 8, then those below 8 in one pass over
// 8 contiguous keys a thread; a barrier a pass, 30 passes for 4,096 keys
// where one a stage took 78.
__device__ void bitonic(unsigned long long* s, int m2) {
  for (int k = 2; k <= m2; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 3) bitonic_pass<3>(s, m2, k, j);
    if (j == 16) bitonic_pass<2>(s, m2, k, 16);
    if (j == 8) bitonic_pass<1>(s, m2, k, 8);
    if (k >= 8) {
      bitonic_pass<3>(s, m2, k, 4);
    } else if (k == 4) {
      bitonic_pass<2>(s, m2, k, 2);
    } else {
      bitonic_pass<1>(s, m2, k, 1);
    }
  }
}

// src[0, m) sorted into s[0, m) (padded to the next power of two).
__device__ void sort_in_shared(unsigned long long* s,
                               const unsigned long long* src, int m) {
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int i = threadIdx.x; i < m2; i += blockDim.x) {
    s[pad(i)] = i < m ? src[i] : kPad;
  }
  __syncthreads();
  bitonic(s, m2);
}

// Block t sorts tile t's segment and writes its pairs, or lists the tile
// when it is longer than a chunk.
__global__ void __launch_bounds__(kThreads)
sort_tiles(const unsigned long long* __restrict__ keys,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, Out o, int* __restrict__ n_long,
           int* __restrict__ long_tiles) {
  extern __shared__ unsigned long long s[];
  const int start = tile_start[blockIdx.x];
  const int len = tile_end[blockIdx.x] - start;
  if (len == 0) return;
  if (len > kChunk) {
    if (threadIdx.x == 0) long_tiles[atomicAdd(n_long, 1)] = blockIdx.x;
    return;
  }
  sort_in_shared(s, keys + start, len);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    write_pair(o, s[pad(i)], start + i);
  }
}

// Block (x, y) sorts chunks y, y + gridDim.y, ... of the x-th listed tile
// and writes them back in place.
__global__ void __launch_bounds__(kThreads)
sort_long_chunks(unsigned long long* __restrict__ keys,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 const int* __restrict__ n_long,
                 const int* __restrict__ long_tiles) {
  __shared__ unsigned long long s[kChunk + kChunk / 8];
  if ((int)blockIdx.x >= *n_long) return;
  const int t = long_tiles[blockIdx.x];
  const int start = tile_start[t];
  const int len = tile_end[t] - start;
  for (int lo = blockIdx.y * kChunk; lo < len; lo += gridDim.y * kChunk) {
    const int m = min(kChunk, len - lo);
    sort_in_shared(s, keys + start + lo, m);
    for (int i = threadIdx.x; i < m; i += kThreads) {
      keys[start + lo + i] = s[pad(i)];
    }
    __syncthreads();
  }
}

// The merge path's split at diagonal d of the sorted runs a[0, na) and
// b[0, nb): how many of their first d merged keys come from a.  By the
// whole warp, 32 probes a step: a[m] comes before b[d - 1 - m] for m below
// the split and not from it on (keys are unique), so the ballot's count
// of true probes narrows the range 33-fold a step.
__device__ long long split_by_warp(const unsigned long long* a, long long na,
                                   const unsigned long long* b, long long nb,
                                   long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = max(0LL, d - nb), hi = min(d, na);
  while (lo < hi) {
    const long long span = hi - lo;
    const long long m = lo + span * (lane + 1) / 33;  // in [lo, hi)
    const int c = __popc(__ballot_sync(0xffffffffu, a[m] < b[d - 1 - m]));
    const long long next_hi = c == 32 ? hi : lo + span * (c + 1) / 33;
    lo = c == 0 ? lo : lo + span * c / 33 + 1;
    hi = next_hi;
  }
  return lo;
}

// One round of the merge over the listed tiles: the sorted runs of
// `width` keys of each segment in `src`, two by two, into `dst` (a last
// run without a partner is copied), or, for the last round (dst null),
// into the pairs.  A block makes kMergeTile consecutive keys of a merged
// pair: two warps find where its slices of the two runs begin and end,
// the block loads them into shared memory, each thread finds its
// kMergeKeys outputs' start there and merges them in order, and the block
// writes the tile out.  Keys are unique, so the merge path is unambiguous.
__global__ void __launch_bounds__(kMergeThreads)
merge_runs(const unsigned long long* __restrict__ src,
           unsigned long long* __restrict__ dst,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, Out o,
           const int* __restrict__ n_long,
           const int* __restrict__ long_tiles, long long width) {
  __shared__ unsigned long long in[kMergeTile];
  __shared__ long long cut[2];
  if ((int)blockIdx.x >= *n_long) return;
  const int t = long_tiles[blockIdx.x];
  const long long start = tile_start[t];
  const long long len = tile_end[t] - start;
  for (long long base = (long long)blockIdx.y * kMergeTile; base < len;
       base += (long long)gridDim.y * kMergeTile) {
    const long long lo = base / (2 * width) * (2 * width);  // the pair
    const long long na = min(width, len - lo);
    const long long nb = max(0LL, min(width, len - lo - na));
    const unsigned long long* a = src + start + lo;
    const unsigned long long* b = a + na;
    const long long d0 = base - lo;  // the tile's merged keys: [d0, d1)
    const long long d1 = min(d0 + kMergeTile, na + nb);
    if (threadIdx.x < 64) {
      const int w = threadIdx.x >> 5;
      const long long i = split_by_warp(a, na, b, nb, w ? d1 : d0);
      if ((threadIdx.x & 31) == 0) cut[w] = i;
    }
    __syncthreads();
    const long long ia = cut[0];
    const int la = (int)(cut[1] - ia);  // a[ia, ia + la), then
    const int lb = (int)(d1 - d0) - la;  // b[d0 - ia, d0 - ia + lb)
    for (int x = threadIdx.x; x < la + lb; x += kMergeThreads) {
      in[x] = x < la ? a[ia + x] : b[d0 - ia + x - la];
    }
    __syncthreads();
    const int k0 = threadIdx.x * kMergeKeys;
    const int outs = min(kMergeKeys, la + lb - k0);
    unsigned long long v[kMergeKeys];
    if (outs > 0) {
      int i0 = max(0, k0 - lb), i1 = min(k0, la);
      while (i0 < i1) {
        const int mid = (i0 + i1) >> 1;
        if (in[mid] < in[la + k0 - 1 - mid]) {
          i0 = mid + 1;
        } else {
          i1 = mid;
        }
      }
      int i = i0, j = k0 - i0;
#pragma unroll
      for (int q = 0; q < kMergeKeys; ++q) {
        if (q < outs) {
          const bool take_a = j >= lb || (i < la && in[i] < in[la + j]);
          v[q] = take_a ? in[i++] : in[la + j++];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMergeKeys; ++q) {
      if (q < outs) in[k0 + q] = v[q];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < la + lb; x += kMergeThreads) {
      const long long pos = start + base + x;
      if (dst) {
        dst[pos] = in[x];
      } else {
        write_pair(o, in[x], pos);
      }
    }
    __syncthreads();
  }
}

unsigned grid_y(long long n, int per) {
  const long long y = (n + per - 1) / per;
  return (unsigned)(y < 1 ? 1 : (y > 65535 ? 65535 : y));
}

int pow2_at_least(long long m) {
  int p = 1;
  while (p < m) p <<= 1;
  return p;
}

}  // namespace

// Keys a sorting block holds: a longer segment takes the long path.
extern "C" int bin_sort_tiles_chunk() { return kChunk; }

// keys: [pairs] uint64 in tile segments (bin_place's; overwritten);
// tile_start, tile_end: [num_tiles] int32; longest: the longest segment
// (bin_count's); mx, my, ca, cb, cc, op: [n] float32, colors: [n, 3]
// float32, all contiguous; records: [9, pairs] float32; gauss_id: [pairs]
// int64; slot_pos: [n, kmax] int32, unfilled; slot_mask: [ceil(kmax / 32),
// n] int32, zeroed here; listed: when longest > kChunk, [1 + max_long]
// int32 (a count, zeroed here, then the tiles longer than a chunk;
// max_long >= pairs / (kChunk + 1) of them can be), and merged: [pairs]
// uint64 scratch, both only when longest > kChunk, else unused.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int bin_sort_tiles(unsigned long long* keys, const int* tile_start,
                              const int* tile_end, int num_tiles,
                              long long longest, const float* mx,
                              const float* my, const float* ca,
                              const float* cb, const float* cc,
                              const float* op, const float* colors,
                              long long n, int kmax, long long pairs,
                              float* records, long long* gauss_id,
                              int* slot_pos, int* slot_mask, int* listed,
                              int max_long, unsigned long long* merged,
                              void* stream) {
  const Out o{mx,       my,     ca,          cb,
              cc,       op,     colors,      (unsigned)n,
              kmax,     pairs,  records,     gauss_id,
              slot_pos, reinterpret_cast<unsigned*>(slot_mask)};
  cudaStream_t s = (cudaStream_t)stream;
  const long long words = (kmax + 31) / 32;
  if (n > 0) cudaMemsetAsync(slot_mask, 0, words * n * sizeof(int), s);
  if (listed) cudaMemsetAsync(listed, 0, sizeof(int), s);
  int* n_long = listed;
  int* long_tiles = listed ? listed + 1 : nullptr;
  const int m2 = pow2_at_least(longest < kChunk ? longest : kChunk);
  // a thread a group of 8 keys of the network's passes, and at least
  // kMinThreads: a frame of short segments has few tiles, and the writes
  // need the threads to keep an SM's gathers in flight
  const int threads = m2 / 8 < kMinThreads ? kMinThreads
                      : (m2 / 8 > kThreads ? kThreads : m2 / 8);
  const size_t smem = (m2 + m2 / 8) * sizeof(unsigned long long);
  sort_tiles<<<num_tiles, threads, smem, s>>>(keys, tile_start, tile_end, o,
                                             n_long, long_tiles);
  if (longest <= kChunk) return (int)cudaGetLastError();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sort_long_chunks<<<dim3(max_long, grid_y(longest, kChunk)), kThreads, 0,
                     s>>>(keys, tile_start, tile_end, n_long, long_tiles);
  unsigned long long* src = keys;
  unsigned long long* dst = merged;
  for (long long width = kChunk; width < longest; width *= 2) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool last = 2 * width >= longest;
    merge_runs<<<dim3(max_long, grid_y(longest, kMergeTile)), kMergeThreads,
                 0, s>>>(src, last ? nullptr : dst, tile_start, tile_end, o,
                         n_long, long_tiles, width);
    unsigned long long* swap = src;
    src = dst;
    dst = swap;
  }
  return (int)cudaGetLastError();
}
