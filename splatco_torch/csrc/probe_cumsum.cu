// Inclusive cumulative sum over rows as a matrix product, out = L x with L
// the lower-triangular matrix of ones: a probe of whether a prefix sum is
// exact enough on the tensor cores.
//
// Replaces the TPU kernel `cs_kernel` of tools/micro_mosaic.py, the product
// at Precision.DEFAULT and HIGHEST.  The function: x [K, N] float32 ->
// out[i, n] = sum over k <= i of x[k, n].  Two modes:
//   0 tf32: the product on the tensor cores with nvcuda::wmma m16n16k8
//           precision::tf32 fragments, x rounded to TF32 with
//           __float_to_tf32 (L's 0 and 1 are exact), sums in fp32 in the
//           tensor core's order.  One warp per 16x16 output tile; L's
//           16x8 block is built in the warp's shared memory; the k-blocks
//           that are all zero above the diagonal are skipped.  Held to a
//           tolerance, not bit for bit.
//   1 fp32: plain fp32 multiply-adds, one thread per output element,
//           k = 0 .. K-1 in order with L's entry as the factor; without
//           fused multiply-adds (--fmad=false) that is the running sum the
//           plain version in splatco_torch/ops/probes.py takes.
// What bounds it: bytes (x read and out written once, 256 KB at the
// probe's 128 x 256) against K(K+1)/2 N multiply-adds.
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTileM = 16, kTileN = 16, kTileK = 8;
constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
cumsum_tf32_kernel(const float* __restrict__ x, int rows, int cols,
                   float* __restrict__ out) {
  __shared__ __align__(32) float s_l[kWarps][kTileM * kTileK];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_n = cols / kTileN;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= (rows / kTileM) * tiles_n) return;  // whole warps only
  const int ti = tile / tiles_n, tj = tile % tiles_n;
  float* l_blk = s_l[warp];

  wmma::fragment<wmma::matrix_a, kTileM, kTileN, kTileK,
                 wmma::precision::tf32, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, kTileM, kTileN, kTileK,
                 wmma::precision::tf32, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, kTileM, kTileN, kTileK, float> acc;
  wmma::fill_fragment(acc, 0.f);
  // k-blocks past the tile's last row are zero in L
  const int k_blocks = (ti + 1) * kTileM / kTileK;
  for (int kb = 0; kb < k_blocks; ++kb) {
#pragma unroll
    for (int t = 0; t < kTileM * kTileK / 32; ++t) {
      const int e = lane + 32 * t;
      const int i = ti * kTileM + e / kTileK;
      const int k = kb * kTileK + e % kTileK;
      l_blk[e] = i >= k ? 1.f : 0.f;
    }
    __syncwarp();
    wmma::load_matrix_sync(a, l_blk, kTileK);
    wmma::load_matrix_sync(b, x + (long long)kb * kTileK * cols + tj * kTileN,
                           cols);
#pragma unroll
    for (int t = 0; t < a.num_elements; ++t) a.x[t] = wmma::__float_to_tf32(a.x[t]);
#pragma unroll
    for (int t = 0; t < b.num_elements; ++t) b.x[t] = wmma::__float_to_tf32(b.x[t]);
    wmma::mma_sync(acc, a, b, acc);
    __syncwarp();  // l_blk is rewritten by the next k-block
  }
  wmma::store_matrix_sync(out + (long long)ti * kTileM * cols + tj * kTileN,
                          acc, cols, wmma::mem_row_major);
}

__global__ void __launch_bounds__(256)
cumsum_fp32_kernel(const float* __restrict__ x, int rows, int cols,
                   float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * cols) return;
  const int i = (int)(idx / cols), n = (int)(idx % cols);
  float s = 0.f;
  for (int k = 0; k < rows; ++k) {
    const float l = i >= k ? 1.f : 0.f;
    s = s + l * x[(long long)k * cols + n];
  }
  out[idx] = s;
}

}  // namespace

// x, out: [rows, cols] float32, rows and cols multiples of 16.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int probe_cumsum(int mode, const float* x, int rows, int cols,
                            float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long elems = (long long)rows * cols;
  if (elems <= 0) return (int)cudaGetLastError();
  if (mode == 0) {
    const int tiles = (rows / kTileM) * (cols / kTileN);
    cumsum_tf32_kernel<<<(tiles + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        x, rows, cols, out);
  } else if (mode == 1) {
    cumsum_fp32_kernel<<<(int)((elems + 255) / 256), 256, 0, st>>>(
        x, rows, cols, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
