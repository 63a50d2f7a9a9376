// The backward's per-gaussian reduce: each gaussian's per-record gradient
// rows summed over its slots.
//
// Replaces the XLA un-sort and reduce of the JAX package's backward
// (splatco_tpu/ops/rasterize.py:140-167: a gather through the inverse of
// the binning's sort and a segment sum).  Computes what
// `reduce_slots_plain` (splatco_torch/ops/rasterize.py) computes: for each
// gaussian n and row r, acc = 0, then for j = 0 .. kmax - 1 in that order
// acc = acc + (slot_pos[j, n] >= 0 ? per_record[r, slot_pos[j, n]] : 0),
// each add rounded to float32 (built with --fmad=false).  An empty slot
// adds +0.0, as the plain version's `where(valid, x, 0.0)` does, so a
// -0.0 sum comes out +0.0 in both.  No float atomics and no scatter: the
// sum's order is fixed, and a step repeats bit for bit.
//
// What bounds it: bytes, the slot map (4 B a slot) read once, coalesced
// across gaussians, the records' nine rows gathered once a pair, and the
// [9, N] sums written once.  A pair's nine rows lie `pairs` floats apart,
// nine sectors a gather, so a first pass packs each record's rows into 48
// contiguous bytes (two sectors).  One thread a gaussian keeps its nine
// sums in registers and loads kAhead slots' records before adding them,
// to keep gathers in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;

// per_record [9, pairs] -> packed [pairs, 3] float4 (rows 0-8, then 0s)
__global__ void __launch_bounds__(kThreads)
pack_records(const float* __restrict__ per_record, long long pairs,
             float4* __restrict__ packed) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const float* c = per_record + p;
  packed[3 * p] = make_float4(c[0], c[pairs], c[2 * pairs], c[3 * pairs]);
  packed[3 * p + 1] = make_float4(c[4 * pairs], c[5 * pairs], c[6 * pairs],
                                  c[7 * pairs]);
  packed[3 * p + 2] = make_float4(c[8 * pairs], 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
reduce_slots(const float4* __restrict__ packed,
             const int* __restrict__ slot_pos, int kmax, long long n,
             float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  float acc[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) acc[r] = 0.0f;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < kmax; j0 += kAhead) {
    float4 a[kAhead], b[kAhead], c[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = j0 + u < kmax ? slot_pos[(long long)(j0 + u) * n + g] : -1;
      a[u] = p >= 0 ? packed[3LL * p] : zero;
      b[u] = p >= 0 ? packed[3LL * p + 1] : zero;
      c[u] = p >= 0 ? packed[3LL * p + 2] : zero;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (j0 + u < kmax) {  // an empty slot adds +0.0
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
#pragma unroll
  for (int r = 0; r < 9; ++r) out[r * n + g] = acc[r];
}

}  // namespace

// per_record: [9, pairs] float32; slot_pos: [kmax, n] int32 (-1: no
// record); packed: [pairs, 12] float32 scratch; out: [9, n] float32; all
// contiguous.  Launches on `stream` and returns cudaGetLastError().
extern "C" int slot_reduce(const float* per_record, long long pairs,
                           const int* slot_pos, int kmax, long long n,
                           float* packed, float* out, void* stream) {
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
  reduce_slots<<<blocks, kThreads, 0, s>>>(rows, slot_pos, kmax, n, out);
  return (int)cudaGetLastError();
}
