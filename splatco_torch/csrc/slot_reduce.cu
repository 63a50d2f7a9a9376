// The backward's per-gaussian reduce: each gaussian's per-record gradient
// rows summed over its slots.
//
// Replaces the XLA un-sort and reduce of the JAX package's backward
// (splatco_tpu/ops/rasterize.py:140-167: a gather through the inverse of
// the binning's sort and a segment sum).  Computes what
// `reduce_slots_plain` (splatco_torch/ops/rasterize.py) computes: for each
// gaussian n and row r, acc = +0.0, then for j = 0 .. kmax - 1 in that
// order acc = acc + (bit j of n's slot mask ? per_record[r, slot_pos[n,
// j]] : +0.0), each add rounded to float32 (built with --fmad=false).  No
// float atomics and no scatter: the sum's order is fixed, and a step
// repeats bit for bit.
//
// The kernel visits only the set bits of the mask, in ascending j, and
// skips the empty slots; that gives the same bits as adding their +0.0.
// The running sum starts at +0.0; in round-to-nearest x + y is -0.0 only
// when both are -0.0, so the sum is never -0.0, and acc + 0.0 == acc for
// every acc that is not -0.0 (a NaN stays the card's canonical NaN, which
// every NaN the adds make already is).  An all -0.0 gaussian sums to +0.0
// either way.
//
// What bounds it: bytes, the mask read once (coalesced across gaussians),
// 4 B of map a pair (a gaussian's entries lie in its own row of the
// gaussian-major map), the records' nine rows gathered once a pair, and
// the [9, N] sums written once.  A pair's nine rows lie `pairs` floats
// apart, nine sectors a gather, so a first pass packs each record's rows
// into 48 contiguous bytes (two sectors).  One thread a gaussian keeps its
// nine sums in registers and loads kAhead set slots' records before adding
// them, to keep gathers in flight; a gaussian with an empty mask (padding,
// or culled) reads one word and writes its nine +0.0.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;

// per_record [9, pairs] -> packed [pairs, 3] float4 (rows 0-8, then 0s).
// A block stages its kThreads records in shared memory and writes them as
// one contiguous run of float4s, each store of a warp 512 contiguous
// bytes (storing a thread's three float4s directly, 48 B apart across a
// warp, measured a third slower on the card: PERF.md).
__global__ void __launch_bounds__(kThreads)
pack_records(const float* __restrict__ per_record, long long pairs,
             float4* __restrict__ packed) {
  __shared__ float4 tile[3 * kThreads];
  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long p = p0 + threadIdx.x;
  if (p < pairs) {
    const float* c = per_record + p;
    tile[3 * threadIdx.x] = make_float4(c[0], c[pairs], c[2 * pairs],
                                        c[3 * pairs]);
    tile[3 * threadIdx.x + 1] = make_float4(c[4 * pairs], c[5 * pairs],
                                            c[6 * pairs], c[7 * pairs]);
    tile[3 * threadIdx.x + 2] = make_float4(c[8 * pairs], 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const long long rows = 3 * min((long long)kThreads, pairs - p0);
  for (int x = threadIdx.x; x < rows; x += kThreads) {
    packed[3 * p0 + x] = tile[x];
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_slots(const float4* __restrict__ packed,
             const int* __restrict__ slot_pos,
             const unsigned* __restrict__ slot_mask, int kmax, long long n,
             float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  float acc[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) acc[r] = 0.0f;
  const int* row = slot_pos + g * kmax;
  for (int w = 0; w < (kmax + 31) / 32; ++w) {
    unsigned m = slot_mask[w * n + g];
    while (m) {
      int p[kAhead];
      int held = 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        p[u] = 0;
        if (m) {  // the lowest set slot next: ascending j
          p[u] = row[32 * w + __ffs(m) - 1];
          m &= m - 1;
          held = u + 1;
        }
      }
      float4 a[kAhead], b[kAhead], c[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (u < held) {
          a[u] = packed[3LL * p[u]];
          b[u] = packed[3LL * p[u] + 1];
          c[u] = packed[3LL * p[u] + 2];
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (u < held) {
          acc[0] = acc[0] + a[u].x;
          acc[1] = acc[1] + a[u].y;
          acc[2] = acc[2] + a[u].z;
          acc[3] = acc[3] + a[u].w;
          acc[4] = acc[4] + b[u].x;
          acc[5] = acc[5] + b[u].y;
          acc[6] = acc[6] + b[u].z;
          acc[7] = acc[7] + b[u].w;
          acc[8] = acc[8] + c[u].x;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 9; ++r) out[r * n + g] = acc[r];
}

}  // namespace

// per_record: [9, pairs] float32; slot_pos: [n, kmax] int32, read only
// where slot_mask ([ceil(kmax / 32), n] int32, bit j % 32 of word j / 32)
// is set; packed: [pairs, 12] float32 scratch; out: [9, n] float32; all
// contiguous.  Launches on `stream` and returns cudaGetLastError().
extern "C" int slot_reduce(const float* per_record, long long pairs,
                           const int* slot_pos, const int* slot_mask,
                           int kmax, long long n, float* packed, float* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float4* rows = reinterpret_cast<float4*>(packed);
  if (pairs > 0) {
    pack_records<<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0,
                   s>>>(per_record, pairs, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks =
      n > 0 ? (unsigned)((n + kThreads - 1) / kThreads) : 1;
  reduce_slots<<<blocks, kThreads, 0, s>>>(
      rows, slot_pos, reinterpret_cast<const unsigned*>(slot_mask), kmax, n,
      out);
  return (int)cudaGetLastError();
}
