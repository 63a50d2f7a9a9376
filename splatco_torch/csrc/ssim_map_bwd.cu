// The SSIM map's backward: the gradients of the five blurred moments
// from the map's cotangent, written as one contiguous [5, n] stack.
//
// Replaces no Pallas kernel: the JAX package takes `jax.grad` of the XLA
// elementwise tail of `_ssim_map` (splatco_tpu/ops/losses.py:109-137).
// Autograd through the eager formula ran ~35 launches, and the five
// slices of the blurred stack each sent back a zero-filled [5B, C, H, W]
// gradient that autograd summed; this writes the stack's gradient once,
// ready for the blur's backward (csrc/sep_blur.cu).
//
// Computes what `_ssim_map_bwd_plain` (splatco_torch/ops/losses.py)
// computes, operation for operation: `ssim::map_vjp` (csrc/ssim.cuh).  The
// cotangent is [n] contiguous.
//
// What bounds it: bytes, the cotangent and the five moments read once and
// the five gradients written once (44 B a pixel) against ~30 fp32
// operations and three divisions a pixel.
// float4 loads and stores where n is a multiple of 4 and the arrays are
// 16 B aligned, over a grid-stride loop.
#include <cstdint>

#include "ssim.cuh"

namespace {

using ssim::kThreads;

__device__ __forceinline__ void store(float* __restrict__ d, long long n,
                                      long long e,
                                      const ssim::MomentGrads& r) {
  d[e] = r.mu1;
  d[n + e] = r.mu2;
  d[2 * n + e] = r.e11;
  d[3 * n + e] = r.e22;
  d[4 * n + e] = r.e12;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
map_bwd(const float* __restrict__ g, const float* __restrict__ stack,
        long long n, float c1, float c2, float* __restrict__ d_stack) {
  const long long stride = (long long)gridDim.x * kThreads;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* s = reinterpret_cast<const float4*>(stack);
    float4* d = reinterpret_cast<float4*>(d_stack);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n4; i += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const float4 mu1 = s[i], mu2 = s[n4 + i], e11 = s[2 * n4 + i],
                   e22 = s[3 * n4 + i], e12 = s[4 * n4 + i];
      const ssim::MomentGrads x = ssim::map_vjp(
          {mu1.x, mu2.x, e11.x, e22.x, e12.x}, gv.x, c1, c2);
      const ssim::MomentGrads y = ssim::map_vjp(
          {mu1.y, mu2.y, e11.y, e22.y, e12.y}, gv.y, c1, c2);
      const ssim::MomentGrads z = ssim::map_vjp(
          {mu1.z, mu2.z, e11.z, e22.z, e12.z}, gv.z, c1, c2);
      const ssim::MomentGrads w = ssim::map_vjp(
          {mu1.w, mu2.w, e11.w, e22.w, e12.w}, gv.w, c1, c2);
      d[i] = make_float4(x.mu1, y.mu1, z.mu1, w.mu1);
      d[n4 + i] = make_float4(x.mu2, y.mu2, z.mu2, w.mu2);
      d[2 * n4 + i] = make_float4(x.e11, y.e11, z.e11, w.e11);
      d[3 * n4 + i] = make_float4(x.e22, y.e22, z.e22, w.e22);
      d[4 * n4 + i] = make_float4(x.e12, y.e12, z.e12, w.e12);
    }
  } else {
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
         e < n; e += stride)
      store(d_stack, n, e,
            ssim::map_vjp(ssim::moments(stack, n, e), g[e], c1, c2));
  }
}

}  // namespace

// g: [n] float32, contiguous; stack: [5, n] float32, contiguous;
// d_stack: [5, n] float32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ssim_map_bwd(const float* g, const float* stack, long long n,
                            float c1, float c2, float* d_stack, int sms,
                            void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = n % 4 == 0 && (uintptr_t)stack % 16 == 0 &&
                   (uintptr_t)d_stack % 16 == 0 && (uintptr_t)g % 16 == 0;
  const long long work = vec ? n / 4 : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 8LL * sms ? blocks : 8LL * sms);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    map_bwd<true><<<grid, kThreads, 0, s>>>(g, stack, n, c1, c2, d_stack);
  else
    map_bwd<false><<<grid, kThreads, 0, s>>>(g, stack, n, c1, c2, d_stack);
  return (int)cudaGetLastError();
}
