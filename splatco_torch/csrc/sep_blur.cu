// Zero-padded SAME separable blur of a stack of planes [P, H, W], both
// passes in one launch: SSIM's Gaussian window over the five stacked
// moments, forward and (the blur being self-adjoint) backward.
//
// Replaces no Pallas kernel: the JAX package blurs with the shifted
// multiply-adds of `_sep_gauss_blur` (splatco_tpu/ops/losses.py:55), which
// XLA fuses into one program a pass, and its custom VJP (:84-106) runs the
// same blur on the cotangent.  Eager PyTorch launches each tap's multiply
// and add on its own (~46 launches and ~11 GB of traffic a blur of the
// training stack); the H100 profile of a step put the blur at ~35 of its
// ~97 busy device ms (PERF.md), hence a hand kernel.
//
// Computes what `_sep_gauss_blur` (splatco_torch/ops/losses.py) computes,
// operation for operation (built with --fmad=false): the vertical pass
//   v[y, c] = t[0] * x[y - R, c];  v = v + t[i] * x[y - R + i, c], i = 1..2R
// with rows outside [0, H) read as +0.0, then the horizontal pass on v
//   out[y, c] = t[0] * v[y, c - R];  out = out + t[i] * v[y, c - R + i]
// with columns outside [0, W) read as +0.0 (zeros, not blurred padding).
// Every padded tap is multiplied and added as the plain version does, so
// signed zeros, infinities and NaNs come out the same.
//
// What bounds it: bytes, each input read once and each output written
// once (8 B a pixel), against ~42 fp32 operations a pixel at R = 5, close
// behind (non-contracted multiplies and adds, 2 an FMA slot).  A block
// owns one plane's strip of kThreads columns (kThreads - 2R output
// columns and R halo columns each side) over kRows rows.  Each thread owns
// one column of the strip and slides down it with the 2R + 1 rows of its
// vertical window in registers, so an input element is read from HBM
// about once (the halo columns and the 2R rows above and below a block's
// rows, ~1.2x at R = 5, are re-read from L2).  kChunk rows at a time go
// through shared memory for the horizontal pass, and the next chunk's
// rows are loaded before it, kChunk loads in flight a thread.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // columns a strip, one a thread
constexpr int kRows = 64;      // rows a block
constexpr int kChunk = 8;      // rows a pass through shared memory
constexpr int kMaxTaps = 31;

struct Taps {
  float t[kMaxTaps];
};

__device__ __forceinline__ float load(const float* __restrict__ x, int y,
                                      int c, int h, int w) {
  return (y >= 0 && y < h && c >= 0 && c < w) ? x[(long long)y * w + c]
                                              : 0.0f;
}

// The minimum of 3 blocks an SM makes the compiler keep radius 5 at 62
// registers, so four blocks fit (80 registers and three without it: 11 %
// slower on the card, PERF.md).
template <int R>
__global__ void __launch_bounds__(kThreads, 3)
blur_planes(const float* __restrict__ in, float* __restrict__ out, int p,
            int h, int w, int col_blocks, Taps taps) {
  constexpr int K = 2 * R + 1;
  __shared__ float v[kChunk][kThreads];
  const int tid = threadIdx.x;
  const int cb = blockIdx.x % col_blocks;
  const int y0 = (blockIdx.x / col_blocks) * kRows;
  const int y1 = min(h, y0 + kRows);
  const int c = cb * (kThreads - 2 * R) - R + tid;  // this thread's column
  const bool writes = tid >= R && tid < kThreads - R && c < w;
  for (int plane = blockIdx.y; plane < p; plane += gridDim.y) {
    const float* x = in + (long long)plane * h * w;
    float* o = out + (long long)plane * h * w;
    float win[K];
#pragma unroll
    for (int i = 1; i < K; ++i) win[i] = load(x, y0 - R + i - 1, c, h, w);
    float next[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) next[j] = load(x, y0 + R + j, c, h, w);
    for (int y = y0; y < y1; y += kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
        win[K - 1] = next[j];
        float s = taps.t[0] * win[0];
#pragma unroll
        for (int i = 1; i < K; ++i) s = s + taps.t[i] * win[i];
        v[j][tid] = (c >= 0 && c < w) ? s : 0.0f;
      }
      if (y + kChunk < y1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          next[j] = load(x, y + kChunk + R + j, c, h, w);
      }
      __syncthreads();
      if (writes) {
        const int rows = min(kChunk, y1 - y);
        for (int j = 0; j < rows; ++j) {
          const float* row = &v[j][tid - R];
          float s = taps.t[0] * row[0];
#pragma unroll
          for (int i = 1; i < K; ++i) s = s + taps.t[i] * row[i];
          o[(long long)(y + j) * w + c] = s;
        }
      }
      __syncthreads();
    }
  }
}

template <int R>
int launch(const float* in, float* out, int p, int h, int w,
           const Taps& taps, cudaStream_t stream) {
  const int col_blocks = (w + kThreads - 2 * R - 1) / (kThreads - 2 * R);
  const int row_blocks = (h + kRows - 1) / kRows;
  const dim3 grid((unsigned)(col_blocks * row_blocks),
                  (unsigned)min(p, 65535));
  blur_planes<R><<<grid, kThreads, 0, stream>>>(in, out, p, h, w,
                                                 col_blocks, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: [p, h, w] float32, contiguous, not overlapping; taps: the
// window's `taps` float32 values on the host (odd, at most 31).  Launches
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// window the kernel does not take).
extern "C" int sep_blur(const float* in, float* out, int p, int h, int w,
                        const float* taps, int n_taps, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (p <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  Taps t{};
  for (int i = 0; i < n_taps; ++i) t.t[i] = taps[i];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_taps / 2) {
    case 0: return launch<0>(in, out, p, h, w, t, s);
    case 1: return launch<1>(in, out, p, h, w, t, s);
    case 2: return launch<2>(in, out, p, h, w, t, s);
    case 3: return launch<3>(in, out, p, h, w, t, s);
    case 4: return launch<4>(in, out, p, h, w, t, s);
    case 5: return launch<5>(in, out, p, h, w, t, s);
    case 6: return launch<6>(in, out, p, h, w, t, s);
    case 7: return launch<7>(in, out, p, h, w, t, s);
    case 8: return launch<8>(in, out, p, h, w, t, s);
    case 9: return launch<9>(in, out, p, h, w, t, s);
    case 10: return launch<10>(in, out, p, h, w, t, s);
    case 11: return launch<11>(in, out, p, h, w, t, s);
    case 12: return launch<12>(in, out, p, h, w, t, s);
    case 13: return launch<13>(in, out, p, h, w, t, s);
    case 14: return launch<14>(in, out, p, h, w, t, s);
    default: return launch<15>(in, out, p, h, w, t, s);
  }
}
