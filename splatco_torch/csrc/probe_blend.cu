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
// order.  Columns outside [0, width) read as 0.  One block of 256 threads
// per chunk, one pixel per thread; the three rows of the chunk's records
// are staged in shared memory and read as broadcasts.  Built with
// --fmad=false, each term rounds like the plain version's in
// splatco_torch/ops/probes.py.  What bounds it: fp32 and SFU work, one
// exp and 6 operations per (pixel, record), 32,768 of them per chunk,
// against 1.5 KB of records and 1 KB of output.
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 128;
constexpr int kPix = 256;

template <bool kExtract>
__global__ void __launch_bounds__(kPix)
blend_probe_kernel(const float* __restrict__ data, long long width,
                   const int* __restrict__ starts, float* __restrict__ out) {
  __shared__ float s_m[kWin], s_q[kWin], s_o[kWin];
  const int c = blockIdx.x;
  const long long p = starts[c];
  const long long col0 = kExtract ? p : (p & ~(long long)(kWin - 1));
  if (threadIdx.x < kWin) {
    const long long col = col0 + threadIdx.x;
    const bool in = col >= 0 && col < width;
    s_m[threadIdx.x] = in ? data[col] : 0.f;
    s_q[threadIdx.x] = in ? data[2 * width + col] : 0.f;
    s_o[threadIdx.x] = in ? data[5 * width + col] : 0.f;
  }
  __syncthreads();
  const float px = (float)threadIdx.x;
  float sum = 0.f;
  for (int k = 0; k < kWin; ++k) {
    const float dx = s_m[k] - px;
    float t = -0.5f * s_q[k];
    t = t * dx;
    t = t * dx;
    sum = sum + s_o[k] * expf(t);
  }
  out[(long long)c * kPix + threadIdx.x] = sum;
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
    blend_probe_kernel<true><<<n, kPix, 0, st>>>(data, width, starts, out);
  } else {
    blend_probe_kernel<false><<<n, kPix, 0, st>>>(data, width, starts, out);
  }
  return (int)cudaGetLastError();
}
