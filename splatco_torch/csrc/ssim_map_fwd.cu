// The SSIM map from the five blurred moments, forward.
//
// Replaces no Pallas kernel: in the JAX package the map is the XLA
// elementwise tail of `_ssim_map` (splatco_tpu/ops/losses.py:109-137),
// fused by XLA into the blur's program.  Eager PyTorch runs it as ~17
// launches over [B, C, H, W] tensors, each read and written through HBM;
// with the blur on its own kernel (csrc/sep_blur.cu) it gets one too.
//
// Computes what `_ssim_map_fwd_plain` (splatco_torch/ops/losses.py)
// computes, operation for operation: `ssim::map` (csrc/ssim.cuh) of each
// pixel's five moments.
//
// What bounds it: bytes, the five moments read once and the map written
// once (24 B a pixel) against ~15 fp32 operations and one division a
// pixel.  A thread takes four consecutive pixels with float4 loads and
// stores where n is a multiple of 4 and the arrays are 16 B aligned,
// else one pixel, over a grid-stride loop.
#include <cstdint>

#include "ssim.cuh"

namespace {

using ssim::kThreads;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
map_fwd(const float* __restrict__ stack, long long n, float c1, float c2,
        float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* s = reinterpret_cast<const float4*>(stack);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n4; i += stride) {
      const float4 mu1 = s[i], mu2 = s[n4 + i], e11 = s[2 * n4 + i],
                   e22 = s[3 * n4 + i], e12 = s[4 * n4 + i];
      float4 r;
      r.x = ssim::map({mu1.x, mu2.x, e11.x, e22.x, e12.x}, c1, c2);
      r.y = ssim::map({mu1.y, mu2.y, e11.y, e22.y, e12.y}, c1, c2);
      r.z = ssim::map({mu1.z, mu2.z, e11.z, e22.z, e12.z}, c1, c2);
      r.w = ssim::map({mu1.w, mu2.w, e11.w, e22.w, e12.w}, c1, c2);
      reinterpret_cast<float4*>(out)[i] = r;
    }
  } else {
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
         e < n; e += stride)
      out[e] = ssim::map(ssim::moments(stack, n, e), c1, c2);
  }
}

}  // namespace

// stack: [5, n] float32, contiguous; out: [n] float32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ssim_map_fwd(const float* stack, long long n, float c1,
                            float c2, float* out, int sms, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = n % 4 == 0 && (uintptr_t)stack % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long work = vec ? n / 4 : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 8LL * sms ? blocks : 8LL * sms);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    map_fwd<true><<<grid, kThreads, 0, s>>>(stack, n, c1, c2, out);
  else
    map_fwd<false><<<grid, kThreads, 0, s>>>(stack, n, c1, c2, out);
  return (int)cudaGetLastError();
}
