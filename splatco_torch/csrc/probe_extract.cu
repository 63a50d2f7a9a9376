// Window row sums at an arbitrary element offset: a probe of the cost of
// reading a record window that does not start on an aligned block.
//
// Replaces the TPU kernel `kernel` of tools/micro_mosaic.py (modes matmul,
// roll, dynslice), which cut the window data[:, p : p + 128] out of the
// two aligned 128-column blocks p // 128 and p // 128 + 1.  The function:
// for chunk c with start p = starts[c], out[c, 0, r] = sum over k < 128
// of data[r, p + k] for each of the 16 rows r, and out[c, 1:8, :] = 0.
// Columns outside [0, width) read as 0.  Three mechanisms, the GPU
// counterparts of the three TPU ones, give the same sums bit for bit:
//   0 direct: each lane reads its columns straight from device memory,
//             unaligned but coalesced;
//   1 smem:   the two aligned blocks are staged in shared memory, then the
//             window is read at offset p % 128;
//   2 shfl:   the two blocks are held in registers (8 per lane) and
//             rotated by p % 128 with warp shuffles (the counterpart of
//             `pltpu.roll`).
// One block of 16 warps per chunk, warp r on row r.  Lane l holds the
// window's columns l + 32 j (j < 4) and sums them in order, then the warp
// adds by an xor-shuffle butterfly (16, 8, 4, 2, 1); the plain version in
// splatco_torch/ops/probes.py adds in that order.  What bounds it: bytes,
// 8 KB of window per chunk for 127 adds per row; at the probe's 64 chunks
// the launch itself dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kWin = 128;
constexpr int kOutRows = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* row, long long col,
                                      long long width) {
  return (col >= 0 && col < width) ? row[col] : 0.f;
}

template <int kMode>
__global__ void __launch_bounds__(kRows * 32)
extract_kernel(const float* __restrict__ data, long long width,
               const int* __restrict__ starts, float* __restrict__ out) {
  const int c = blockIdx.x;
  const int r = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p = starts[c];
  const long long block0 = p & ~(long long)(kWin - 1);  // floor to 128
  const int off = (int)(p - block0);                    // p % 128
  const float* row = data + r * width;
  float v[4];
  if constexpr (kMode == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load(row, p + lane + 32 * j, width);
  } else if constexpr (kMode == 1) {
    __shared__ float s_blk[kRows][2 * kWin];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s_blk[r][lane + 32 * i] = load(row, block0 + lane + 32 * i, width);
    __syncwarp();  // each warp reads back only its own row
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = s_blk[r][off + lane + 32 * j];
  } else {
    float blk[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      blk[i] = load(row, block0 + lane + 32 * i, width);
    // lane l needs column off + l + 32 j of the 256, held by lane
    // (l + off) % 32 in register (off + l) / 32 + j; as a source, lane m
    // sends register off / 32 + j, or the next one when m < off % 32
    const int q = off / 32, s = off % 32;
    const int src = (lane + s) % 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = q + j + (lane < s ? 1 : 0);
      float mine = blk[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mine = slot == i ? blk[i] : mine;
      v[j] = __shfl_sync(kFull, mine, src);
    }
  }
  float sum = v[0] + v[1];
  sum = sum + v[2];
  sum = sum + v[3];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) sum = sum + __shfl_xor_sync(kFull, sum, o);
  float* dst = out + (long long)c * kOutRows * kRows;
  if (lane == 0) dst[r] = sum;
  if (threadIdx.x < (kOutRows - 1) * kRows) dst[kRows + threadIdx.x] = 0.f;
}

}  // namespace

// data: [16, width] float32; starts: [n] int32; out: [n, 8, 16] float32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_extract(int mode, const float* data, long long width,
                             const int* starts, int n, float* out,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      extract_kernel<0><<<n, kRows * 32, 0, st>>>(data, width, starts, out);
      break;
    case 1:
      extract_kernel<1><<<n, kRows * 32, 0, st>>>(data, width, starts, out);
      break;
    case 2:
      extract_kernel<2><<<n, kRows * 32, 0, st>>>(data, width, starts, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
