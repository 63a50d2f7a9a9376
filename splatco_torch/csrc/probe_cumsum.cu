// Inclusive cumulative sum over rows as a matrix product, out = L x with L
// the lower-triangular matrix of ones: a probe of whether a prefix sum is
// exact enough on the tensor cores.
//
// Replaces the TPU kernel `cs_kernel` of tools/micro_mosaic.py, the product
// at Precision.DEFAULT and HIGHEST.  The function is the reference's L x:
// out[i, n] = the float32 running sum x[0, n] + ... + x[i, n], and NaN
// wherever a later row k > i of the column holds inf or NaN (L's zero
// times it).  Two modes:
//   0 tf32: a blocked scan on the tensor cores.  L's 16x16 diagonal block
//           (two 16x8 halves, built once in registers as mma fragments)
//           times each 16-row tile of x, mma.sync m16n8k8 with x rounded
//           to TF32 (cvt.rna, as wmma::__float_to_tf32), gives the tile's
//           own prefix sums; the tiles above it add as an fp32 carry, the
//           sum of their products' last rows.  Held to 5e-4 of the max,
//           with NaN and inf where the plain version has them.
//   1 fp32: a thread a column adds its rows in order from +0.0, the plain
//           version's running sum in splatco_torch/ops/probes.py bit for
//           bit (no fused multiply-adds: --fmad=false).
//
// The design: a block stages a strip of kStrip columns of every row in
// shared memory once, with 16 B loads, kBatch of them in flight a thread,
// noting each column's last non-finite row as it goes (the rows above it
// are written NaN) and, for tf32, rounding each value once.  tf32: a warp
// takes an 8-column n-tile, two mma a 16-row tile, every tile's product
// independent of the others but for the carry.  The triangular product
// (L's nonzero 16x8 blocks, up to 16 a tile) ran 72 mma a 128-row column
// of 8 against the blocked scan's 16 and was bound by mma.sync's rate.
// fp32: each thread carries its column's running sum down the strip.
// Strips of 16 columns (16, 32 and 64 measured, and 64-thread blocks)
// spread the probe's 256 columns over 16 SMs.  What bounds it: bytes (x
// read and out written once: 256 KB at the probe's 128 x 256, 64 MiB at
// 128 x 65,536).
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 16;            // columns a block
constexpr int kStride = kStrip + 8;   // floats a staged row: conflict-free
constexpr int kThreads = 128;
constexpr int kTileN = 8;             // mma n
constexpr unsigned kOne = 0x3f800000u;  // 1.0f, exact in TF32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The strip's columns col0 .. col0 + kStrip - 1 (those below `cols`) of
// every row into s_x, TF32-rounded if kTf32; s_last[c] the strip column's
// last row with a non-finite value, -1 if none.  A thread loads kBatch
// 16 B groups before it stores any, so they are in flight together, and
// the first batch is in flight while s_last is set.
template <bool kTf32, bool kVec>
__device__ __forceinline__ void stage(const float* __restrict__ x, int rows,
                                      int cols, int col0, float* s_x,
                                      int* s_last) {
  constexpr int kGroups = kStrip / 4;  // 16 B groups a staged row
  constexpr int kBatch = 8;
  const int width = min(kStrip, cols - col0);  // a multiple of 16
  const int total = rows * kGroups;
  for (int e0 = 0; e0 < total; e0 += kBatch * kThreads) {  // block-uniform
    float v[kBatch][4];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int e = e0 + t * kThreads + threadIdx.x;
      const int r = e / kGroups, c = 4 * (e % kGroups);
      const float* src = x + (long long)r * cols + col0 + c;
      if (e >= total || c >= width) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[t][q] = 0.f;
      } else if constexpr (kVec) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src));
        v[t][0] = f.x;
        v[t][1] = f.y;
        v[t][2] = f.z;
        v[t][3] = f.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[t][q] = __ldg(src + q);
      }
    }
    if (e0 == 0) {  // the first batch
      if (threadIdx.x < kStrip) s_last[threadIdx.x] = -1;
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int e = e0 + t * kThreads + threadIdx.x;
      const int r = e / kGroups, c = 4 * (e % kGroups);
      if (e >= total || c >= width) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!isfinite(v[t][q])) atomicMax(&s_last[c + q], r);
        if constexpr (kTf32) v[t][q] = to_tf32(v[t][q]);
      }
      *reinterpret_cast<float4*>(&s_x[r * kStride + c]) =
          make_float4(v[t][0], v[t][1], v[t][2], v[t][3]);
    }
  }
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cumsum_tf32_kernel(const float* __restrict__ x, int rows, int cols,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float s_x[];  // [rows][kStride]
  __shared__ int s_last[kStrip];
  const int col0 = blockIdx.x * kStrip;
  stage<true, kVec>(x, rows, cols, col0, s_x, s_last);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma's group and thread
  // L's diagonal 16x16 block as two A fragments (rows gid / gid + 8,
  // columns tig / tig + 4): the left half r >= c, the right r >= c + 8
  const unsigned d0[4] = {gid >= tig ? kOne : 0u, kOne,
                          gid >= tig + 4 ? kOne : 0u, kOne};
  const unsigned d1[4] = {0u, gid >= tig ? kOne : 0u, 0u,
                          gid >= tig + 4 ? kOne : 0u};
  const int n_tiles = min(kStrip, cols - col0) / kTileN;
  // a warp an 8-column n-tile: B fragments x[k + tig][gid] and x[k + tig
  // + 4][gid] of each 8-row k-block k; the C fragment's rows gid and
  // gid + 8, columns 2 tig and 2 tig + 1, of each 16-row tile
  for (int nt = warp; nt < n_tiles; nt += kThreads / 32) {
    const int c = nt * kTileN + 2 * tig;
    const int last0 = s_last[c], last1 = s_last[c + 1];
    const float* b = s_x + tig * kStride + nt * kTileN + gid;
    float* dst = out + (long long)gid * cols + col0 + c;
    float carry0 = 0.f, carry1 = 0.f;
#pragma unroll 8
    for (int t = 0; t < rows / 16; ++t) {
      const float* bt = b + 16 * t * kStride;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(acc, d0, __float_as_uint(bt[0]),
               __float_as_uint(bt[4 * kStride]));
      mma_tf32(acc, d1, __float_as_uint(bt[8 * kStride]),
               __float_as_uint(bt[12 * kStride]));
      // the tile's total is its row 15: lanes 28-31 (gid 7), c2 and c3
      const float tot0 = __shfl_sync(kFull, acc[2], 28 + tig);
      const float tot1 = __shfl_sync(kFull, acc[3], 28 + tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * t + 8 * h;  // the row, less gid
        float2 v = make_float2(acc[2 * h] + carry0, acc[2 * h + 1] + carry1);
        if (i + gid < last0) v.x = nan_f();
        if (i + gid < last1) v.y = nan_f();
        *reinterpret_cast<float2*>(dst + (long long)i * cols) = v;
      }
      carry0 = carry0 + tot0;
      carry1 = carry1 + tot1;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cumsum_fp32_kernel(const float* __restrict__ x, int rows, int cols,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float s_x[];  // [rows][kStride]
  __shared__ int s_last[kStrip];
  const int col0 = blockIdx.x * kStrip;
  stage<false, kVec>(x, rows, cols, col0, s_x, s_last);
  const int c = threadIdx.x;
  if (c >= kStrip || col0 + c >= cols) return;
  const int last = s_last[c];
  float* dst = out + col0 + c;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < rows; ++i) {
    s = s + s_x[i * kStride + c];
    dst[(long long)i * cols] = i < last ? nan_f() : s;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, const float* x, int rows,
           int cols, float* out, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused size is no fault of a later launch
      return (int)err;
    }
  }
  kernel<<<blocks, kThreads, smem, st>>>(x, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, cols] float32, rows and cols multiples of 16, rows at
// most 1024 (the staged strip: 96 KB of shared memory); out 8 B aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_cumsum(int mode, const float* x, int rows, int cols,
                            float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if (rows % 16 || cols % 16 || rows > 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (cols + kStrip - 1) / kStrip;
  const size_t smem = (size_t)rows * kStride * sizeof(float);
  const bool vec = (unsigned long long)x % 16 == 0;
  if (mode == 0) {
    return vec ? launch(cumsum_tf32_kernel<true>, blocks, smem, x, rows, cols,
                        out, st)
               : launch(cumsum_tf32_kernel<false>, blocks, smem, x, rows,
                        cols, out, st);
  }
  return vec ? launch(cumsum_fp32_kernel<true>, blocks, smem, x, rows, cols,
                      out, st)
             : launch(cumsum_fp32_kernel<false>, blocks, smem, x, rows, cols,
                      out, st);
}
