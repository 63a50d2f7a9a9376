// Tile alpha-blend forward and backward for NVIDIA Hopper (sm_90a),
// templated on the pixel tile's side: 32 (the v2 configuration,
// raster_fwd.cu / raster_bwd.cu) or 16 (the v3 configuration,
// raster_fwd16.cu / raster_bwd16.cu).  Each .cu file instantiates one
// kernel behind a plain C entry point; cuda_lib.library_path hashes this
// header with every source, so an edit here rebuilds all four.
//
// The blend contract (splatco_tpu/ops/rasterize_reference.py): for every
// pixel of a tile, walk the tile's depth-sorted records front to back:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  d = mean - pixel centre
//   skip if power > 0;  alpha = min(0.99, op exp(power));  skip if
//   alpha < 1/255;  if T (1 - alpha) < 1e-4 the pixel is done, before
//   this record contributes;  else C += colour alpha T, T *= 1 - alpha.
// Pixel centres sit on integer coordinates.  Pixels beyond H/W start
// done; a tile with no records writes rgb 0 and T 1.
//
// Layout (simple and right first): one block of 256 threads per tile.
// Thread t owns column t % kTile and rows t / kTile + k (256 / kTile) for
// k < kTile^2 / 256: four pixels of one column at 32 px (a warp covers a
// pixel row), one pixel at 16 px (a warp covers two pixel rows).
// Records are staged through shared memory in batches and read as
// broadcasts; the block leaves early once __syncthreads_count of live
// pixels is 0.  No atomics: every launch is bit-identical run to run.
//
// Built with --fmad=false so the float32 arithmetic rounds op for op like
// the plain PyTorch versions in splatco_torch/ops/rasterize_cuda.py.
#pragma once

#include <cuda_runtime.h>

namespace raster_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRec = 9;   // mx, my, ca, cb, cc, op, r, g, b
constexpr int kSums = 9;  // S, Sx, Sy, Sxx, Sxy, Syy, Sr, Sg, Sb
constexpr unsigned kFull = 0xffffffffu;

// Forward: rgb [3, Hp, Wp] without background and T_final [Hp, Wp] in
// image layout.  What bounds it on an H100: the bytes are small (9 x 4 B
// per record read once, 16 B per pixel written), so it is bound by fp32
// and SFU work: ~16 operations and one exp per pixel evaluation up to
// termination, ~10 more per contribution.
template <int kTile>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ rec, long long num_rec,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, int tiles_x, int height,
           int width, float* __restrict__ rgb, float* __restrict__ t_final) {
  constexpr int kRows = kTile * kTile / kThreads;  // pixels per thread
  constexpr int kRowStep = kThreads / kTile;
  constexpr int kBatch = kThreads;                 // records staged at once
  // the same float32 constants as the plain version's Python scalars
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.99;
  const float t_eps = (float)1e-4;

  __shared__ float s_rec[kRec][kBatch];

  const int tile = blockIdx.x;
  const int wp = tiles_x * kTile;
  const int hp = (gridDim.x / tiles_x) * kTile;
  const int x = (tile % tiles_x) * kTile + (threadIdx.x % kTile);
  const int y0 = (tile / tiles_x) * kTile + (threadIdx.x / kTile);
  const float px = (float)x;

  float py[kRows], T[kRows], c0[kRows], c1[kRows], c2[kRows];
  bool live[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + k * kRowStep;
    py[k] = (float)y;
    T[k] = 1.f;
    c0[k] = c1[k] = c2[k] = 0.f;
    live[k] = x < width && y < height;
  }

  const int start = tile_start[tile];
  const int end = tile_end[tile];
  for (int base = start; base < end; base += kBatch) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRows; ++k) any |= live[k];
    // also the barrier that frees s_rec from the previous batch
    if (__syncthreads_count(any) == 0) break;
    const int i = base + threadIdx.x;
    if (i < end) {
#pragma unroll
      for (int c = 0; c < kRec; ++c) s_rec[c][threadIdx.x] = rec[c * num_rec + i];
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      const float mx = s_rec[0][j], my = s_rec[1][j];
      const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
      const float op = s_rec[5][j];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!live[k]) continue;
        const float dx = mx - px;
        const float dy = my - py[k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (!(power <= 0.f)) continue;
        const float alpha = fminf(alpha_max, op * expf(power));
        if (!(alpha >= alpha_min)) continue;
        const float test_t = T[k] * (1.f - alpha);
        if (test_t < t_eps) {
          live[k] = false;
          continue;
        }
        const float w = alpha * T[k];
        c0[k] = c0[k] + s_rec[6][j] * w;
        c1[k] = c1[k] + s_rec[7][j] * w;
        c2[k] = c2[k] + s_rec[8][j] * w;
        T[k] = test_t;
      }
    }
  }

  const long long plane = (long long)hp * wp;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long idx = (long long)(y0 + k * kRowStep) * wp + x;
    rgb[idx] = c0[k];
    rgb[plane + idx] = c1[k];
    rgb[2 * plane + idx] = c2[k];
    t_final[idx] = T[k];
  }
}

// Backward: the gradient of the blended image with respect to every
// record, given the image's cotangent g, the forward's rgb (no
// background) and T_final.  Per pixel gtot = sum_c rgb_c g_c + (sum_c
// bg_c g_c) T_final; the replay repeats fwd_kernel's arithmetic op for op,
// so a pixel terminates at the same record, and for each contributing
// record (w = alpha T_before):
//   gc = sum_c col_c g_c;  prefix += gc w;
//   dalpha = gc T_before - (gtot - prefix) / max(1 - alpha, 0.01);
//   dpower = alpha < 0.99 ? dalpha alpha : 0.
// The nine per-record sums over the tile's pixels (dp, dp dx, dp dy,
// dp dx dx, dp dx dy, dp dy dy, g_c w) go through an xor-shuffle butterfly
// in each warp (skipped when no lane touched the record); lane 0 parks the
// warp's partials in shared memory, and after the batch one thread per
// record adds the 8 warps' partials in warp order and writes the record's
// gradients: d_mx = -(ca Sx + cb Sy), d_my = -(cb Sx + cc Sy),
// d_ca = -Sxx / 2, d_cb = -Sxy, d_cc = -Syy / 2, d_op = S / max(op, 1e-12),
// and the colour sums.  Every sum has a fixed order and there are no
// atomics.  The block stops once no pixel is live; the records after that
// keep the zeros the wrapper's output starts with.  What bounds it: fp32
// and SFU work, the forward's ~16 operations per evaluation plus ~35 per
// contribution, and the per-record warp reductions on top (one per 256
// pixels at 16 px, per 1024 at 32 px).
template <int kTile>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ rec, long long num_rec,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, int tiles_x, int height,
           int width, const float* __restrict__ grad,
           const float* __restrict__ rgb, const float* __restrict__ t_final,
           const float* __restrict__ bg, float* __restrict__ out) {
  constexpr int kRows = kTile * kTile / kThreads;  // pixels per thread
  constexpr int kRowStep = kThreads / kTile;
  constexpr int kBatch = 128;                      // records staged at once
  // the same float32 constants as the plain version's Python scalars
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.99;
  const float t_eps = (float)1e-4;
  const float one_m_min = (float)(1.0 - 0.99);
  const float op_min = (float)1e-12;

  __shared__ float s_rec[kRec][kBatch];
  __shared__ float s_part[kWarps][kSums][kBatch];

  const int tile = blockIdx.x;
  const int wp = tiles_x * kTile;
  const int hp = (gridDim.x / tiles_x) * kTile;
  const long long plane = (long long)hp * wp;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int x = (tile % tiles_x) * kTile + (threadIdx.x % kTile);
  const int y0 = (tile / tiles_x) * kTile + (threadIdx.x / kTile);
  const float px = (float)x;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];

  float py[kRows], T[kRows], prefix[kRows], gtot[kRows];
  float g0[kRows], g1[kRows], g2[kRows];
  bool live[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + k * kRowStep;
    const long long idx = (long long)y * wp + x;
    py[k] = (float)y;
    T[k] = 1.f;
    prefix[k] = 0.f;
    live[k] = x < width && y < height;
    g0[k] = grad[idx];
    g1[k] = grad[plane + idx];
    g2[k] = grad[2 * plane + idx];
    gtot[k] = (rgb[idx] * g0[k] + rgb[plane + idx] * g1[k]
               + rgb[2 * plane + idx] * g2[k])
              + (bg0 * g0[k] + bg1 * g1[k] + bg2 * g2[k]) * t_final[idx];
  }

  const int start = tile_start[tile];
  const int end = tile_end[tile];
  for (int base = start; base < end; base += kBatch) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRows; ++k) any |= live[k];
    // also the barrier that frees s_rec and s_part from the last batch
    if (__syncthreads_count(any) == 0) break;
    const int n = min(kBatch, end - base);
    if (threadIdx.x < n) {
#pragma unroll
      for (int c = 0; c < kRec; ++c)
        s_rec[c][threadIdx.x] = rec[c * num_rec + base + threadIdx.x];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float mx = s_rec[0][j], my = s_rec[1][j];
      const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
      const float op = s_rec[5][j];
      const float cr = s_rec[6][j], cg = s_rec[7][j], cbl = s_rec[8][j];
      float s[kSums];
#pragma unroll
      for (int c = 0; c < kSums; ++c) s[c] = 0.f;
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!live[k]) continue;
        const float dx = mx - px;
        const float dy = my - py[k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (!(power <= 0.f)) continue;
        const float alpha = fminf(alpha_max, op * expf(power));
        if (!(alpha >= alpha_min)) continue;
        const float one_m = 1.f - alpha;
        const float test_t = T[k] * one_m;
        if (test_t < t_eps) {
          live[k] = false;
          continue;
        }
        const float w = alpha * T[k];
        const float gc = cr * g0[k] + cg * g1[k] + cbl * g2[k];
        prefix[k] = prefix[k] + gc * w;
        const float d_alpha =
            gc * T[k] - (gtot[k] - prefix[k]) / fmaxf(one_m, one_m_min);
        const float dp = alpha < alpha_max ? d_alpha * alpha : 0.f;
        const float dpx = dp * dx;
        const float dpy = dp * dy;
        s[0] = s[0] + dp;
        s[1] = s[1] + dpx;
        s[2] = s[2] + dpy;
        s[3] = s[3] + dpx * dx;
        s[4] = s[4] + dpx * dy;
        s[5] = s[5] + dpy * dy;
        s[6] = s[6] + g0[k] * w;
        s[7] = s[7] + g1[k] * w;
        s[8] = s[8] + g2[k] * w;
        T[k] = test_t;
        hit = true;
      }
      if (__any_sync(kFull, hit)) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            s[c] = s[c] + __shfl_xor_sync(kFull, s[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) s_part[warp][c][j] = s[c];
      }
    }
    __syncthreads();
    if (threadIdx.x < n) {
      const int j = threadIdx.x;
      float r[kSums];
#pragma unroll
      for (int c = 0; c < kSums; ++c) {
        float v = s_part[0][c][j];
#pragma unroll
        for (int wi = 1; wi < kWarps; ++wi) v = v + s_part[wi][c][j];
        r[c] = v;
      }
      const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
      const float op = s_rec[5][j];
      const long long i = base + j;
      out[0 * num_rec + i] = -(ca * r[1] + cb * r[2]);
      out[1 * num_rec + i] = -(cb * r[1] + cc * r[2]);
      out[2 * num_rec + i] = -0.5f * r[3];
      out[3 * num_rec + i] = -r[4];
      out[4 * num_rec + i] = -0.5f * r[5];
      out[5 * num_rec + i] = r[0] / fmaxf(op, op_min);
      out[6 * num_rec + i] = r[6];
      out[7 * num_rec + i] = r[7];
      out[8 * num_rec + i] = r[8];
    }
  }
}

// rec: [9, num_rec] float32 SoA records, tile segments in depth order;
// tile_start/tile_end: [tiles_x * tiles_y] int32; rgb: [3, Hp, Wp];
// t_final: [Hp, Wp], Hp = kTile tiles_y, Wp = kTile tiles_x.  Launches on
// `stream` and returns cudaGetLastError().
template <int kTile>
int launch_fwd(const float* rec, long long num_rec, const int* tile_start,
               const int* tile_end, int tiles_x, int tiles_y, int height,
               int width, float* rgb, float* t_final, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    fwd_kernel<kTile><<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        rec, num_rec, tile_start, tile_end, tiles_x, height, width, rgb,
        t_final);
  }
  return (int)cudaGetLastError();
}

// As launch_fwd, plus grad, rgb: [3, Hp, Wp]; t_final: [Hp, Wp]; bg: [3];
// out: [9, num_rec], zero-filled by the caller.
template <int kTile>
int launch_bwd(const float* rec, long long num_rec, const int* tile_start,
               const int* tile_end, int tiles_x, int tiles_y, int height,
               int width, const float* grad, const float* rgb,
               const float* t_final, const float* bg, float* out,
               void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    bwd_kernel<kTile><<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        rec, num_rec, tile_start, tile_end, tiles_x, height, width, grad,
        rgb, t_final, bg, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace raster_tile
