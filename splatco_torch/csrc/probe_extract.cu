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
//   0 direct: each lane reads its window columns straight from device
//             memory, unaligned but coalesced (4 B a lane);
//   1 smem:   the two aligned blocks are copied into shared memory with
//             16 B cp.async (the counterpart of the TPU's block DMA), then
//             the window is read at offset p % 128;
//   2 shfl:   the two blocks are loaded into registers with aligned 16 B
//             loads (lane m holds columns 4m .. 4m+3 of each) and moved to
//             the lanes that sum them by four rounds of warp shuffles (the
//             counterpart of `pltpu.roll`).
// The aligned modes take 16 B only where every row is 16 B aligned (width
// a multiple of 4 and data on a 16 B boundary); otherwise they read the
// same columns 4 B at a time.
//
// The order of the adds is fixed: lane l sums the window's columns l + 32 j
// (j < 4) in order, then the 32 lanes add by an xor butterfly (16, 8, 4,
// 2, 1).  extract_rows_plain in splatco_torch/ops/probes.py adds in that
// order.  A warp takes kRows rows of a chunk at once and splits the first
// levels of the butterfly between them: at offset 16 a lane keeps half of
// the rows and sends its partner the other half, and so on until each
// lane holds one row, whose remaining levels are the plain butterfly.
// Every add is the one the single-row butterfly makes (own partial plus
// the partner's, at the same level), so the bits are the same, with
// kRows - 1 + 5 - log2 kRows shuffles a group instead of 5 a row.  Row r
// of the group ends in lanes r << (5 - log2 kRows) and up.
//
// What bounds it: bytes, the distinct window columns read once (8 KB a
// chunk; 64 MiB at the 8,192-window kernel scale, 0.02 ms).  The design
// keeps the reads in flight: a warp issues every load of its kRows rows
// before the first add, and the aligned modes move 16 B a load.  At the
// tool's 64 chunks the launch and the two dependent round trips (the
// start, then the window) dominate.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsAll = 16;  // rows of data
constexpr int kWin = 128;
constexpr int kOutRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// rows a warp sums at once and warps a block, in every mode (1-16 rows,
// 2-8 warps and 1-4 chunks a warp were measured: PERF.md §6)
constexpr int kRows = 2;
constexpr int kWarps = 8;
constexpr int kGroups = kRowsAll / kRows;  // warps a chunk
constexpr int kShift = kRows == 16 ? 1 : kRows == 8 ? 2 : kRows == 4 ? 3
                     : kRows == 2 ? 4 : 5;  // 5 - log2 kRows
static_assert(kRows == 1 << (5 - kShift), "kRows: a power of 2 <= 16");

__device__ __forceinline__ float load(const float* row, long long col,
                                      long long width) {
  return (col >= 0 && col < width) ? row[col] : 0.f;
}

// columns g .. g+3 of a row (g a multiple of 4), 0 outside [0, width)
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, long long g,
                                        long long width) {
  if constexpr (kVec) {
    return (g >= 0 && g + 4 <= width)
               ? __ldg(reinterpret_cast<const float4*>(row + g))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(load(row, g, width), load(row, g + 1, width),
                       load(row, g + 2, width), load(row, g + 3, width));
  }
}

__device__ __forceinline__ void to_array(float4 f, float (&a)[4]) {
  a[0] = f.x;
  a[1] = f.y;
  a[2] = f.z;
  a[3] = f.w;
}

// b[j] = a[(j + c) & 3]: a rotation by a lane's own amount, by selects
__device__ __forceinline__ void rotate(float (&a)[4], int c) {
  float t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = (c & 1) ? a[(j + 1) & 3] : a[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = (c & 2) ? t[(j + 2) & 3] : t[j];
}

// The first log2(kWidth) levels of the butterfly, split between the
// rows s[0 .. kWidth-1] a lane holds: at offset kO a lane keeps the half
// of its rows that its bit kO selects and adds its partner's partials of
// them; the rows it keeps are s[0 .. kWidth/2 - 1] after.
template <int kWidth, int kO, int kN>
__device__ __forceinline__ void split_levels(float (&s)[kN], int lane) {
  if constexpr (kWidth > 1) {
    const bool upper = lane & kO;  // keep the upper half, send the lower
#pragma unroll
    for (int h = 0; h < kWidth / 2; ++h) {
      const float keep = upper ? s[h + kWidth / 2] : s[h];
      const float send = upper ? s[h] : s[h + kWidth / 2];
      s[h] = keep + __shfl_xor_sync(kFull, send, kO);
    }
    split_levels<kWidth / 2, kO / 2>(s, lane);
  }
}

// The butterfly over kRows rows' lane partials s[0 .. kRows-1]; returns
// the sum of row lane >> kShift, in every lane of that row.
__device__ __forceinline__ float butterfly(float (&s)[kRows], int lane) {
  split_levels<kRows, 16>(s, lane);
  float sum = s[0];
#pragma unroll
  for (int o = 16 / kRows; o > 0; o /= 2)
    sum = sum + __shfl_xor_sync(kFull, sum, o);
  return sum;
}

template <int kMode, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
extract_kernel(const float* __restrict__ data, long long width,
               const int* __restrict__ starts, int n,
               float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  const long long c = g / kGroups;
  if (c >= n) return;  // whole warps only
  const int r0 = (int)(g % kGroups) * kRows;
  const long long p = starts[c];
  const long long block0 = p & ~(long long)(kWin - 1);  // floor to 128
  const int off = (int)(p - block0);                    // p % 128
  float s[kRows];
  if constexpr (kMode == 0) {
    float v[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* row = data + (r0 + i) * width;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = load(row, p + lane + 32 * j,
                                                 width);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = v[i][0] + v[i][1];
      s[i] = s[i] + v[i][2];
      s[i] = s[i] + v[i][3];
    }
  } else if constexpr (kMode == 1) {
    __shared__ __align__(16) float s_blk[kWarps][kRows][2 * kWin];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* row = data + (r0 + i) * width;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const long long col = block0 + b * kWin + 4 * lane;
        float* dst = &s_blk[warp][i][b * kWin + 4 * lane];
        if constexpr (kVec) {
          const bool in = col >= 0 && col + 4 <= width;
          const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                       :: "r"(d), "l"(in ? row + col : row),
                       "r"(in ? 16 : 0));
        } else {
          *reinterpret_cast<float4*>(dst) = load4<false>(row, col, width);
        }
      }
    }
    if constexpr (kVec) asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();  // each warp reads back only its own rows
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* w = &s_blk[warp][i][off + lane];
      s[i] = w[0] + w[32];
      s[i] = s[i] + w[64];
      s[i] = s[i] + w[96];
    }
  } else {
    // Round t: lane m sends its window value of register k = (t + m / 8)
    // & 3, column 4m + k of block 0 if that is at or past the window's
    // start, else of block 1; lane l receives from lane 8 ((u & 3) - t
    // & 3) + (u & 31) / 4, u = l + off, the value of window column
    // l + 32 j with j = (u & 3) - u / 32 - t (mod 4).  Every lane sends
    // and receives one value a round, so four rounds bring each lane its
    // four columns (tests/test_torch_probes.py restates this).
    const int sm = lane >> 3;
    const int u = lane + off;
    const int cl = ((u & 3) - (u >> 5)) & 3;
    int src[4];
    bool first[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      src[t] = 8 * (((u & 3) - t) & 3) + ((u & 31) >> 2);
      first[t] = 4 * lane + ((t + sm) & 3) >= off;
    }
    float b[kRows][2][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* row = data + (r0 + i) * width;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        to_array(load4<kVec>(row, block0 + h * kWin + 4 * lane, width),
                 b[i][h]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      rotate(b[i][0], sm);  // register t now holds (t + sm) & 3
      rotate(b[i][1], sm);
      float got[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        got[t] = __shfl_sync(kFull, first[t] ? b[i][0][t] : b[i][1][t],
                             src[t]);
      // got[t] is column l + 32 ((cl - t) & 3): v[j] = got[(cl - j) & 3]
      float v[4] = {got[0], got[3], got[2], got[1]};  // v'[j] = got[-j]
      rotate(v, (4 - cl) & 3);
      s[i] = v[0] + v[1];
      s[i] = s[i] + v[2];
      s[i] = s[i] + v[3];
    }
  }
  const float sum = butterfly(s, lane);
  float* dst = out + c * kOutRows * kRowsAll;
  if ((lane & ((1 << kShift) - 1)) == 0) dst[r0 + (lane >> kShift)] = sum;
  if (r0 == 0 && lane >= kRowsAll / 4)  // rows 1-7: 16 B of zeros a lane
    reinterpret_cast<float4*>(dst)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kMode>
int launch(const float* data, long long width, const int* starts, int n,
           float* out, cudaStream_t st) {
  const long long warps = (long long)n * kGroups;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const bool vec = width % 4 == 0 && (unsigned long long)data % 16 == 0;
  if (vec) {
    extract_kernel<kMode, true><<<blocks, kWarps * 32, 0, st>>>(
        data, width, starts, n, out);
  } else {
    extract_kernel<kMode, false><<<blocks, kWarps * 32, 0, st>>>(
        data, width, starts, n, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// data: [16, width] float32; starts: [n] int32; out: [n, 8, 16] float32
// (16 B aligned).  Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_extract(int mode, const float* data, long long width,
                             const int* starts, int n, float* out,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch<0>(data, width, starts, n, out, st);
    case 1: return launch<1>(data, width, starts, n, out, st);
    case 2: return launch<2>(data, width, starts, n, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
