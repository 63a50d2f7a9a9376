// Alpha evaluation alone over 1-D pixels, from an aligned record block or
// from a window at an arbitrary offset: a probe of the cost of the alpha
// evaluation and of the window's offset at kernel scale.
//
// Replaces the TPU kernel `blend_kernel` of tools/micro_mosaic.py
// (extract off / on).  The function: for chunk c the records are the 128
// columns of data [16, width] from col0 = 128 (p // 128) (extract off) or
// col0 = p (extract on), p = starts[c]; with m, q, o the rows 0, 2 and 5
// of column col0 + k,
//   out[c, px] = sum over k < 128 of o * exp((-0.5 q) (m - px) (m - px))
// for the pixels px = 0 .. 255 (out [n, 2, 128] is [n, 256]), summed in k
// order from +0.0.  Columns outside [0, width) read as 0.  Built with
// --fmad=false and with libdevice's expf, each term rounds like the plain
// version's in splatco_torch/ops/probes.py.
//
// What bounds it: the exp.  Each (pixel, record) pair costs one MUFU.EX2
// on the special-function unit (16 a clock an SM) and, around it,
// libdevice's range reduction and scaling (7 instructions) and the
// pair's own 5 (m - px, two products, o e, the sum): 13 issue slots a
// pair against 8 clocks of the SFU a warp, so instruction issue, not the
// SFU, is the wall.  The design cuts the instructions that are not the
// pair's own: the staging pass stores each record as one 16 B (m, -0.5 q,
// o) entry in shared memory (the product -0.5 q once a record, the same
// bits as once a pixel), and each thread evaluates kPx pixels of its
// chunk, so one broadcast 16 B load serves kPx pairs and the kPx
// independent sums give the scheduler work between a pair's dependent
// steps.  A block is one warp on one chunk: with 32-thread blocks the
// compiler keeps 64 registers and the SMs share the 8,192 chunks in
// fine grains (measured fastest against 64-256-thread blocks of 2-8
// pixels a thread; PERF.md §6).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 128;
constexpr int kPix = 256;
constexpr int kPx = 8;                 // pixels a thread
constexpr int kThreads = kPix / kPx;   // a warp a chunk, a chunk a block

template <bool kExtract>
__global__ void __launch_bounds__(kThreads)
blend_probe_kernel(const float* __restrict__ data, long long width,
                   const int* __restrict__ starts, float* __restrict__ out) {
  __shared__ float4 s_rec[kWin];  // (m, -0.5 q, o, unused)
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const long long p = starts[c];
  const long long col0 = kExtract ? p : (p & ~(long long)(kWin - 1));
  for (int k = lane; k < kWin; k += kThreads) {
    const long long col = col0 + k;
    const bool in = col >= 0 && col < width;
    const float m = in ? data[col] : 0.f;
    const float q = in ? data[2 * width + col] : 0.f;
    const float o = in ? data[5 * width + col] : 0.f;
    s_rec[k] = make_float4(m, -0.5f * q, o, 0.f);
  }
  __syncthreads();
  float px[kPx], sum[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    px[j] = (float)(lane + j * kThreads);
    sum[j] = 0.f;
  }
#pragma unroll 8
  for (int k = 0; k < kWin; ++k) {
    const float4 r = s_rec[k];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const float dx = r.x - px[j];
      float t = r.y * dx;
      t = t * dx;
      sum[j] = sum[j] + r.z * expf(t);
    }
  }
  float* dst = out + (long long)c * kPix + lane;
#pragma unroll
  for (int j = 0; j < kPx; ++j) dst[j * kThreads] = sum[j];
}

}  // namespace

// data: [16, width] float32 (rows 0, 2, 5 read); starts: [n] int32; out:
// [n, 256] float32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_blend(int extract, const float* data, long long width,
                           const int* starts, int n, float* out,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (extract) {
    blend_probe_kernel<true><<<n, kThreads, 0, st>>>(data, width, starts, out);
  } else {
    blend_probe_kernel<false><<<n, kThreads, 0, st>>>(data, width, starts,
                                                      out);
  }
  return (int)cudaGetLastError();
}
