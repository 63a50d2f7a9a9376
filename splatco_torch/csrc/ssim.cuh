// The SSIM map's elementwise arithmetic, shared by csrc/ssim_map_fwd.cu and
// csrc/ssim_map_bwd.cu.  Each function repeats, operation for operation,
// the torch ops of its plain version in splatco_torch/ops/losses.py
// (`_ssim_map_fwd_plain`, `_ssim_map_bwd_plain`); the sources are built
// with --fmad=false, so no multiply and add contract into one rounding,
// and `/` is IEEE round-to-nearest division (no fast math).
//
// The stack holds the five blurred moments of n = B * C * H * W pixels,
// moment k of pixel e at stack[k * n + e]: mu1, mu2, E[x1^2], E[x2^2],
// E[x1 x2].  c1 and c2 are the float32 roundings of 0.01^2 and 0.03^2,
// as torch rounds a Python scalar for a float32 tensor.
#pragma once

#include <cuda_runtime.h>

namespace ssim {

constexpr int kThreads = 256;

struct Moments {
  float mu1, mu2, e11, e22, e12;
};

__device__ __forceinline__ Moments moments(const float* __restrict__ stack,
                                           long long n, long long e) {
  return {stack[e], stack[n + e], stack[2 * n + e], stack[3 * n + e],
          stack[4 * n + e]};
}

// The forward: `_ssim_map`'s formula.
__device__ __forceinline__ float map(const Moments& m, float c1, float c2) {
  const float mu1_sq = m.mu1 * m.mu1;
  const float mu2_sq = m.mu2 * m.mu2;
  const float mu1_mu2 = m.mu1 * m.mu2;
  const float sigma1_sq = m.e11 - mu1_sq;
  const float sigma2_sq = m.e22 - mu2_sq;
  const float sigma12 = m.e12 - mu1_mu2;
  return ((2.0f * mu1_mu2 + c1) * (2.0f * sigma12 + c2)) /
         (((mu1_sq + mu2_sq) + c1) * ((sigma1_sq + sigma2_sq) + c2));
}

// The map's VJP for the cotangent g of one pixel: the gradients of its
// five moments, in the stack's order.
struct MomentGrads {
  float mu1, mu2, e11, e22, e12;
};

__device__ __forceinline__ MomentGrads map_vjp(const Moments& m, float g,
                                               float c1, float c2) {
  const float mu1_sq = m.mu1 * m.mu1;
  const float mu2_sq = m.mu2 * m.mu2;
  const float mu1_mu2 = m.mu1 * m.mu2;
  const float a = 2.0f * mu1_mu2 + c1;
  const float b = 2.0f * (m.e12 - mu1_mu2) + c2;
  const float d = (mu1_sq + mu2_sq) + c1;
  const float e = ((m.e11 - mu1_sq) + (m.e22 - mu2_sq)) + c2;
  const float den = d * e;
  const float g_num = g / den;
  const float g_den = -g * ((a * b) / den / den);
  const float g_b = g_num * a;
  const float g_e = g_den * d;
  const float g_mu1_mu2 = 2.0f * (g_num * b) - 2.0f * g_b;
  const float g_sq = g_den * e - g_e;
  return {2.0f * m.mu1 * g_sq + m.mu2 * g_mu1_mu2,
          2.0f * m.mu2 * g_sq + m.mu1 * g_mu1_mu2, g_e, g_e, 2.0f * g_b};
}

}  // namespace ssim
