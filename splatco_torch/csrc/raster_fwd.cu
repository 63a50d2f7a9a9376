// Tile alpha-blend forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// splatco_tpu/ops/rasterize_pallas.py (launched by `forward_pallas`).
// It computes the same function: for every pixel of a 32x32 tile, walk the
// tile's depth-sorted records front to back with the blend contract of
// splatco_tpu/ops/rasterize_reference.py:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  d = mean - pixel centre
//   skip if power > 0;  alpha = min(0.99, op exp(power));  skip if
//   alpha < 1/255;  if T (1 - alpha) < 1e-4 the pixel is done, before
//   this record contributes;  else C += colour alpha T, T *= 1 - alpha.
// Output is in image layout: rgb [3, Hp, Wp] without background and the
// final transmittance [Hp, Wp].  The TPU kernel's log-depth cumprod over
// 128-record chunks is TPU machinery; here each thread runs the serial
// per-pixel loop, the CUDA 3DGS form.
//
// Design (simple and right first): one block of 256 threads per tile,
// each thread owning 4 pixels of one column (rows ly, ly+8, ly+16,
// ly+24), so a warp covers one pixel row and the stores coalesce.  The
// block stages 256 records x 9 floats (9 KB) at a time through shared
// memory, reads them as broadcasts, and leaves early once
// __syncthreads_count of live pixels is 0.  Pixels beyond H/W start done.
// No atomics: the result is the same run to run.
//
// What bounds it on an H100: the bytes are small (9 x 4 B per record
// read once, 16 B per pixel written), so it is bound by fp32 and SFU
// work: about 1024 pixel evaluations (~16 fp32 ops and one exp each) per
// (tile, record) pair up to termination, ~10 more ops for each
// contribution.  Making it fast is later work: a persistent grid,
// cp.async/TMA double-buffered record staging, 16x16 thread tiles with
// per-warp early-out.
//
// Built with --fmad=false so the float32 arithmetic rounds op for op like
// the plain PyTorch version in splatco_torch/ops/rasterize_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kRows = kTile * kTile / kThreads;  // pixels per thread: 4
constexpr int kBatch = kThreads;                 // records staged at once
constexpr int kRec = 9;  // mx, my, ca, cb, cc, op, r, g, b

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ rec, long long num_rec,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int tiles_x,
                  int height, int width, float* __restrict__ rgb,
                  float* __restrict__ t_final) {
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
    const int y = y0 + k * (kThreads / kTile);
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
    const long long idx = (long long)(y0 + k * (kThreads / kTile)) * wp + x;
    rgb[idx] = c0[k];
    rgb[plane + idx] = c1[k];
    rgb[2 * plane + idx] = c2[k];
    t_final[idx] = T[k];
  }
}

}  // namespace

// rec: [9, num_rec] float32 SoA records, tile segments in depth order;
// tile_start/tile_end: [tiles_x * tiles_y] int32; rgb: [3, Hp, Wp];
// t_final: [Hp, Wp], Hp = 32 tiles_y, Wp = 32 tiles_x.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int raster_fwd(const float* rec, long long num_rec,
                          const int* tile_start, const int* tile_end,
                          int tiles_x, int tiles_y, int height, int width,
                          float* rgb, float* t_final, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    raster_fwd_kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        rec, num_rec, tile_start, tile_end, tiles_x, height, width, rgb,
        t_final);
  }
  return (int)cudaGetLastError();
}
