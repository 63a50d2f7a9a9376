// Tile binning, pass 3 of 3: each tile's keys sorted, and the records, the
// gaussian ids and the slot map written from them.
//
// Replaces the `jax.lax.sort`s and gathers of the XLA binning of
// splatco_tpu/ops/binning.py:210 `bin_gaussians` (:277, :300) and
// splatco_tpu/ops/raster_v3.py `bin_gaussians_v3` (see binning.cuh).
// Computes what `bin_sort_tiles_plain` (splatco_torch/ops/binning.py)
// computes: each segment [tile_start, tile_end) of `keys` sorted ascending
// (the keys of a tile are unique, so the result does not depend on the
// order bin_place left them in), and for the key at position p, with low
// word e = j * N + n: gauss_id[p] = n, records[:, p] = gaussian n's nine
// columns (mx, my, ca, cb, cc, op, r, g, b), slot_pos[e] = p.
//
// What bounds it: bytes, the keys read, the 36 B record and 8 B id written
// a pair, and the int32 slot map, 4 B a slot (the wrapper's -1 fill, each
// pair's entry then written over it).  A block a
// tile sorts a segment of up to kChunk keys (32 KiB) in shared memory (a
// bitonic network over the next power of two) and writes it out directly.
// (Packing a gaussian's nine columns into 48 contiguous bytes before the
// gather measured slower on the main path's frames, PERF.md.)  A longer
// segment (a tile near the camera, or one many gaussians cover) is cut
// into kChunk chunks: the tile's block sorts the first and lists the tile;
// a second kernel, over the listed tiles only (at most pairs / (kChunk +
// 1)), sorts the other chunks in parallel, each written back in place; a
// third gives each key of such a segment its rank, its index in its chunk
// plus a binary search in each other chunk, and writes it out there.  That
// search costs O(L^2 / kChunk log kChunk) for a segment of L keys.  The
// host launches the last two only when bin_count's longest segment needs
// them.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;   // keys a block sorts in shared memory
constexpr int kThreads = 512;  // threads a sorting block
constexpr int kRankThreads = 256;
constexpr unsigned long long kPad = ~0ULL;  // above every key

struct Out {
  const float *mx, *my, *ca, *cb, *cc, *op, *colors;  // colors [n, 3]
  long long n, pairs;
  float* records;        // [9, pairs]
  long long* gauss_id;   // [pairs]
  int* slot_pos;         // [kmax, n], -1 filled
};

__device__ __forceinline__ void write_pair(const Out& o,
                                           unsigned long long key,
                                           long long pos) {
  const long long e = (long long)(key & 0xffffffffULL);
  const long long g = e % o.n;
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
  o.slot_pos[e] = (int)pos;
}

// Sorts s[0, m2) ascending, m2 a power of two, with the whole block.
__device__ void bitonic(unsigned long long* s, int m2) {
  for (int k = 2; k <= m2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (m2 >> 1); p += blockDim.x) {
        const int i = 2 * j * (p / j) + p % j;  // the pair (i, i + j)
        const unsigned long long a = s[i], b = s[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Sorts chunk [lo, lo + kChunk) of the segment at `seg` (len keys) in
// shared memory, then writes its pairs (a segment of one chunk) or the
// sorted keys back in place.
__device__ void sort_chunk(unsigned long long* s, unsigned long long* seg,
                           int start, int len, int lo, const Out& o) {
  const int m = min(kChunk, len - lo);
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int i = threadIdx.x; i < m2; i += kThreads) {
    s[i] = i < m ? seg[lo + i] : kPad;
  }
  __syncthreads();
  bitonic(s, m2);
  if (len <= kChunk) {
    for (int i = threadIdx.x; i < m; i += kThreads) {
      write_pair(o, s[i], start + i);
    }
  } else {
    for (int i = threadIdx.x; i < m; i += kThreads) seg[lo + i] = s[i];
  }
  __syncthreads();
}

// Block t sorts tile t's segment, or its first chunk when it is longer
// than a chunk, and then lists the tile for the passes below.
__global__ void __launch_bounds__(kThreads)
sort_tiles(unsigned long long* __restrict__ keys,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, Out o, int* __restrict__ n_long,
           int* __restrict__ long_tiles) {
  __shared__ unsigned long long s[kChunk];
  const int start = tile_start[blockIdx.x];
  const int len = tile_end[blockIdx.x] - start;
  if (len == 0) return;
  sort_chunk(s, keys + start, start, len, 0, o);
  if (len > kChunk && threadIdx.x == 0) {
    long_tiles[atomicAdd(n_long, 1)] = blockIdx.x;
  }
}

// Block (x, y) sorts chunks y + 1, y + 1 + gridDim.y, ... of the x-th
// listed tile.
__global__ void __launch_bounds__(kThreads)
sort_long_chunks(unsigned long long* __restrict__ keys,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, Out o,
                 const int* __restrict__ n_long,
                 const int* __restrict__ long_tiles) {
  __shared__ unsigned long long s[kChunk];
  if ((int)blockIdx.x >= *n_long) return;
  const int t = long_tiles[blockIdx.x];
  const int start = tile_start[t];
  const int len = tile_end[t] - start;
  for (int lo = (blockIdx.y + 1) * kChunk; lo < len;
       lo += gridDim.y * kChunk) {
    sort_chunk(s, keys + start, start, len, lo, o);
  }
}

// Keys of `sorted[0, m)` below `key`.
__device__ __forceinline__ int below(const unsigned long long* sorted, int m,
                                     unsigned long long key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// For the x-th listed tile, whose chunks are sorted: each key's rank in
// the segment, and its pair written there.
__global__ void __launch_bounds__(kRankThreads)
rank_long(const unsigned long long* __restrict__ keys,
          const int* __restrict__ tile_start,
          const int* __restrict__ tile_end, Out o,
          const int* __restrict__ n_long,
          const int* __restrict__ long_tiles) {
  if ((int)blockIdx.x >= *n_long) return;
  const int t = long_tiles[blockIdx.x];
  const int start = tile_start[t];
  const int len = tile_end[t] - start;
  const int chunks = (len + kChunk - 1) / kChunk;
  const unsigned long long* seg = keys + start;
  for (int i = blockIdx.y * kRankThreads + threadIdx.x; i < len;
       i += gridDim.y * kRankThreads) {
    const unsigned long long key = seg[i];
    const int own = i / kChunk;
    int rank = i - own * kChunk;
    for (int b = 0; b < chunks; ++b) {
      if (b == own) continue;
      const int lo = b * kChunk;
      rank += below(seg + lo, min(kChunk, len - lo), key);
    }
    write_pair(o, key, start + rank);
  }
}

unsigned grid_y(long long n, int per) {
  const long long y = (n + per - 1) / per;
  return (unsigned)(y < 1 ? 1 : (y > 65535 ? 65535 : y));
}

}  // namespace

// Keys a sorting block holds: a longer segment is sorted in chunks.
extern "C" int bin_sort_tiles_chunk() { return kChunk; }

// keys: [pairs] uint64 in tile segments (bin_place's; sorted in place);
// tile_start, tile_end: [num_tiles] int32; longest: the longest segment
// (bin_count's); mx, my, ca, cb, cc, op: [n] float32, colors: [n, 3]
// float32, all contiguous; records: [9, pairs] float32; gauss_id: [pairs]
// int64; slot_pos: [kmax, n] int32 filled with -1; listed: when longest >
// kChunk, [1 + max_long] int32 zeroed (a count, then the tiles longer
// than a chunk; max_long >= pairs / (kChunk + 1) of them can be), else
// unused.  Launches on `stream` and returns cudaGetLastError().
extern "C" int bin_sort_tiles(unsigned long long* keys, const int* tile_start,
                              const int* tile_end, int num_tiles,
                              long long longest, const float* mx,
                              const float* my, const float* ca,
                              const float* cb, const float* cc,
                              const float* op, const float* colors,
                              long long n, long long pairs, float* records,
                              long long* gauss_id, int* slot_pos,
                              int* listed, int max_long, void* stream) {
  const Out o{mx, my, ca, cb, cc, op, colors, n, pairs, records, gauss_id,
              slot_pos};
  cudaStream_t s = (cudaStream_t)stream;
  int* n_long = listed;
  int* long_tiles = listed ? listed + 1 : nullptr;
  sort_tiles<<<num_tiles, kThreads, 0, s>>>(keys, tile_start, tile_end, o,
                                            n_long, long_tiles);
  if (longest > kChunk) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sort_long_chunks<<<dim3(max_long, grid_y(longest - kChunk, kChunk)),
                       kThreads, 0, s>>>(keys, tile_start, tile_end, o,
                                         n_long, long_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rank_long<<<dim3(max_long, grid_y(longest, kRankThreads)), kRankThreads,
                0, s>>>(keys, tile_start, tile_end, o, n_long, long_tiles);
  }
  return (int)cudaGetLastError();
}
