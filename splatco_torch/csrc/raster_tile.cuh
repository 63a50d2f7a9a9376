// Tile alpha-blend forward for NVIDIA Hopper (sm_90a), templated on the
// pixel tile's side: 32 (the v2 configuration, raster_fwd.cu) or 16 (the
// v3 configuration, raster_fwd16.cu); the backward is in
// raster_bwd_tile.cuh.  Each .cu file instantiates one kernel behind a
// plain C entry point (raster_fwd16_ablate.cu: the forward's timing
// variants, see `Variant`); cuda_lib.library_path hashes every header
// with every source, so an edit here rebuilds them all.
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
constexpr int kRec = 9;  // mx, my, ca, cb, cc, op, r, g, b
constexpr unsigned kFull = 0xffffffffu;

// Forward variants.  The production kernels are kFull; the others exist
// only to time the parts of the forward (raster_fwd16_ablate.cu):
//   kNoStage: records read by every thread straight from device memory,
//     not staged through shared memory; the same image as kFull.
//   kNoScan:  no transmittance chain: T stays 1, so w = alpha, and a
//     pixel stops after the first record with alpha > 0.97 (that record
//     included); T_final is 1.
//   kNoAccum: the chain and its termination without the colour sums (the
//     colours are not staged); rgb is 0, T_final is kFull's.
enum Variant { kFullBlend = 0, kNoStage = 1, kNoScan = 2, kNoAccum = 3 };

// Forward: rgb [3, Hp, Wp] without background and T_final [Hp, Wp] in
// image layout.  What bounds it on an H100: the bytes are small (9 x 4 B
// per record read once, 16 B per pixel written), so it is bound by fp32
// and SFU work: ~16 operations and one exp per pixel evaluation up to
// termination, ~10 more per contribution.
template <int kTile, int kVariant = kFullBlend>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ rec, long long num_rec,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, int tiles_x, int height,
           int width, float* __restrict__ rgb, float* __restrict__ t_final) {
  constexpr int kRows = kTile * kTile / kThreads;  // pixels per thread
  constexpr int kRowStep = kThreads / kTile;
  constexpr int kBatch = kThreads;                 // records staged at once
  // rows staged: the colours are not read without the colour sums
  constexpr int kStaged = kVariant == kNoAccum ? 6 : kRec;
  // the same float32 constants as the plain version's Python scalars
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.99;
  const float t_eps = (float)1e-4;
  const float noscan_stop = (float)0.97;

  __shared__ float s_rec[kVariant == kNoStage ? 1 : kStaged][kBatch];

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
    if constexpr (kVariant != kNoStage) {
      const int i = base + threadIdx.x;
      if (i < end) {
#pragma unroll
        for (int c = 0; c < kStaged; ++c)
          s_rec[c][threadIdx.x] = rec[c * num_rec + i];
      }
      __syncthreads();
    }
    // row c of the batch's record j
    auto at = [&](int c, int j) {
      if constexpr (kVariant == kNoStage) return rec[c * num_rec + base + j];
      else return s_rec[c][j];
    };
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      const float mx = at(0, j), my = at(1, j);
      const float ca = at(2, j), cb = at(3, j), cc = at(4, j);
      const float op = at(5, j);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!live[k]) continue;
        const float dx = mx - px;
        const float dy = my - py[k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (!(power <= 0.f)) continue;
        const float alpha = fminf(alpha_max, op * expf(power));
        if (!(alpha >= alpha_min)) continue;
        if constexpr (kVariant == kNoScan) {
          c0[k] = c0[k] + at(6, j) * alpha;
          c1[k] = c1[k] + at(7, j) * alpha;
          c2[k] = c2[k] + at(8, j) * alpha;
          if (alpha > noscan_stop) live[k] = false;
          continue;
        }
        const float test_t = T[k] * (1.f - alpha);
        if (test_t < t_eps) {
          live[k] = false;
          continue;
        }
        if constexpr (kVariant != kNoAccum) {
          const float w = alpha * T[k];
          c0[k] = c0[k] + at(6, j) * w;
          c1[k] = c1[k] + at(7, j) * w;
          c2[k] = c2[k] + at(8, j) * w;
        }
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

// rec: [9, num_rec] float32 SoA records, tile segments in depth order;
// tile_start/tile_end: [tiles_x * tiles_y] int32; rgb: [3, Hp, Wp];
// t_final: [Hp, Wp], Hp = kTile tiles_y, Wp = kTile tiles_x.  Launches on
// `stream` and returns cudaGetLastError().
template <int kTile, int kVariant = kFullBlend>
int launch_fwd(const float* rec, long long num_rec, const int* tile_start,
               const int* tile_end, int tiles_x, int tiles_y, int height,
               int width, float* rgb, float* t_final, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    fwd_kernel<kTile, kVariant><<<num_tiles, kThreads, 0,
                                  (cudaStream_t)stream>>>(
        rec, num_rec, tile_start, tile_end, tiles_x, height, width, rgb,
        t_final);
  }
  return (int)cudaGetLastError();
}

}  // namespace raster_tile
