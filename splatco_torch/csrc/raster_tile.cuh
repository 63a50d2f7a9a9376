// Tile alpha-blend forward for NVIDIA Hopper (sm_90a), templated on the
// pixel tile's side: 32 (the v2 configuration, raster_fwd.cu) or 16 (the
// v3 configuration, raster_fwd16.cu), the block size and a register cap;
// the backward is in raster_bwd_tile.cuh, which shares this file's warp
// layout and cull.  Each .cu file instantiates one kernel behind a plain C
// entry point (raster_fwd16_ablate.cu: the forward's timing variants, see
// `Variant`); cuda_lib.library_path hashes every header with every source,
// so an edit here rebuilds them all.
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
// What bounds the forward on an H100: the bytes are small (9 x 4 B per
// record read once, 16 B per pixel written), so it is bound by fp32 and
// SFU issue: ~16 operations and one exp per pixel evaluation up to
// termination, ~10 more per contribution.  The first layout (one pixel
// row per warp at 32 px, one pixel per thread at 16 px) spent its issue
// slots on work that changes nothing: six shared loads a record and
// thread, every warp evaluating every record of the tile, and warps whose
// pixels were done reading on until the whole block was.  The design:
//  - Each warp owns a compact kRectW x kRectH pixel rectangle and each
//    lane one column of it, kRows pixels (`WarpLayout`), so a lane's
//    evaluations of one record share dx and its products.
//  - Records are staged through shared memory in batches of kFwdBatch as
//    (mx my ca cb | cc op r g | b) in one float4 array: a warp reads a
//    record with two broadcast 128-bit loads from one base address.
//  - Each warp tests 32 staged records at a time against its rectangle
//    (`cull_rect`, one record a lane), ballots the ones that may reach it
//    and walks only the set bits (__ffs), in record order.  The skip is
//    exact: a culled record gives power > 0 or alpha < 1/255 at every
//    pixel of the rectangle under this very arithmetic, so it changes
//    neither T nor any colour there.
//  - A warp with no live pixel stops reading records and only joins the
//    staging barrier; the block stops once no pixel of it is live.
//  - A pixel's liveness is the sign of its T (a byte flag cost two or
//    three byte permutes an evaluation), and its two skip tests are one
//    predicate after the exp, which the warp runs anyway.
//  - kMinBlocks caps the registers: the kernel is bound by its issue
//    rate, and more resident warps beat the registers that the unrolled
//    pixels would otherwise take.
// No atomics: every launch is bit-identical run to run.
//
// Built with --fmad=false so the float32 arithmetic rounds op for op like
// the plain PyTorch versions in splatco_torch/ops/rasterize_cuda.py.
#pragma once

#include <cuda_runtime.h>

namespace raster_tile {

constexpr int kRec = 9;  // mx, my, ca, cb, cc, op, r, g, b
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdBatch = 128;  // records the forward stages at once

// Forward variants.  The production kernels are kFullBlend; the others
// exist only to time the parts of the forward (raster_fwd16_ablate.cu):
//   kNoStage: records read by every lane straight from device memory
//     (for the cull and the evaluations), not staged through shared
//     memory; the same image as kFullBlend.
//   kNoScan:  no transmittance chain: T stays 1, so w = alpha, and a
//     pixel stops after the first record with alpha > 0.97 (that record
//     included); T_final is 1.
//   kNoAccum: the chain and its termination without the colour sums (the
//     colours are not staged); rgb is 0, T_final is kFullBlend's.
enum Variant { kFullBlend = 0, kNoStage = 1, kNoScan = 2, kNoAccum = 3 };

// Conservative cull of one record against the pixel centres of [x0, x1] x
// [y0, y1]: true only if at every such pixel the blend's own float32
// arithmetic gives power > 0 or alpha < 1/255, so the record changes
// nothing there.  With q(d) = ca dx^2 + 2 cb dx dy + cc dy^2 (power =
// -q / 2) and S(d) = ca dx^2 + cc dy^2, the computed power is within
// 6 u S(d) of the exact one (u = 2^-24), so it is below -Q'(d) / 2 for the
// shrunk form Q' = q - 2e-5 S.  The test bounds Q' from below over the
// rectangle (0 if the centre is inside it, else the least of its four
// edges, each a one-dimensional quadratic) and compares with log(255 op),
// every rounding covered by a margin.  A NaN opacity or conic keeps the
// record (a NaN mean reaches no pixel).  The plain version is
// `cull_rect_plain` in ops/rasterize_cuda.py.
__device__ __forceinline__ float cull_dist_lb(float s, float lo, float hi) {
  const float d = fmaxf(lo - s, s - hi);
  return fmaxf(d - 1e-6f * (fabsf(s) + fabsf(lo) + fabsf(hi)), 0.f);
}

__device__ __forceinline__ bool cull_rect(float mx, float my, float ca,
                                          float cb, float cc, float op,
                                          float x0, float x1, float y0,
                                          float y1) {
  float lim = logf(op * 255.f);
  lim = lim + 1e-4f + 1e-6f * fabsf(lim);
  const float a = ca * (1.f - 2e-5f);
  const float c = cc * (1.f - 2e-5f);
  const float b = cb;
  if (!(a > 0.f && c > 0.f)) return false;
  const float ac = a * c, bb = b * b;
  const float det = (ac - bb) - 1e-6f * (ac + bb);
  if (!(det > 0.f)) return false;
  const float ex = 1e-6f * (fabsf(mx) + fabsf(x0) + fabsf(x1));
  const float ey = 1e-6f * (fabsf(my) + fabsf(y0) + fabsf(y1));
  const float dx0 = (mx - x1) - ex, dx1 = (mx - x0) + ex;
  const float dy0 = (my - y1) - ey, dy1 = (my - y0) + ey;
  float lb = 0.f;
  if (!(dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f)) {
    // edge dx = e: Q' = c (dy + b e / c)^2 + det e^2 / c; dy = e alike
    auto edge_x = [&](float e) {
      const float t = cull_dist_lb(-b * e / c, dy0, dy1);
      return det * e * e / c + c * t * t;
    };
    auto edge_y = [&](float e) {
      const float t = cull_dist_lb(-b * e / a, dx0, dx1);
      return det * e * e / a + a * t * t;
    };
    lb = fminf(fminf(edge_x(dx0), edge_x(dx1)),
               fminf(edge_y(dy0), edge_y(dy1)));
  }
  return lb * (0.5f * (1.f - 1e-5f)) > lim;
}

// The layout of a block of kBlock threads over a kTile x kTile tile: each
// of its warps owns a kRectW x kRectH rectangle (the warps row-major over
// the tile), each lane one column of it (kRows pixels, 32 / kRectW rows
// apart).
template <int kTile, int kBlock>
struct WarpLayout {
  static constexpr int kWarps = kBlock / 32;
  static constexpr int kRows = kTile * kTile / kBlock;  // pixels per lane
  static constexpr int kRectW = kRows * 32 >= 128 ? 16 : 8;
  static constexpr int kRectH = kRows * 32 / kRectW;
  static constexpr int kRowStep = 32 / kRectW;
  static constexpr int kWarpsX = kTile / kRectW;
  static_assert(kWarps * kRectW * kRectH == kTile * kTile, "layout");
  static_assert(kRectW <= kTile && kTile % kRectW == 0, "layout");
};

// Forward: rgb [3, Hp, Wp] without background and T_final [Hp, Wp] in
// image layout, one block per tile.
template <int kTile, int kBlock, int kMinBlocks, int kVariant = kFullBlend>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
fwd_kernel(const float* __restrict__ rec, long long num_rec,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, int tiles_x, int tiles_y,
           int height, int width, float* __restrict__ rgb,
           float* __restrict__ t_final) {
  using L = WarpLayout<kTile, kBlock>;
  constexpr int kRows = L::kRows;
  constexpr int kBatch = kFwdBatch;
  constexpr bool kStaged = kVariant != kNoStage;
  constexpr bool kColour = kVariant != kNoAccum;
  // the same float32 constants as the plain version's Python scalars
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.99;
  const float t_eps = (float)1e-4;
  const float noscan_stop = (float)0.97;

  // record j of the batch: s_rec[0][j] = (mx, my, ca, cb), s_rec[1][j] =
  // (cc, op, r, g), s_rec[2][j].x = b; one base address for all three
  __shared__ float4 s_rec[kStaged ? 3 : 1][kStaged ? kBatch : 1];

  const int tile = blockIdx.x;
  const int wp = tiles_x * kTile;
  const int hp = tiles_y * kTile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rx0 = (tile % tiles_x) * kTile + (warp % L::kWarpsX) * L::kRectW;
  const int ry0 = (tile / tiles_x) * kTile + (warp / L::kWarpsX) * L::kRectH;
  const int x = rx0 + lane % L::kRectW;
  const int y0 = ry0 + lane / L::kRectW;
  const float px = (float)x;
  const float rx0f = (float)rx0, rx1f = (float)(rx0 + L::kRectW - 1);
  const float ry0f = (float)ry0, ry1f = (float)(ry0 + L::kRectH - 1);

  // T > 0 marks a live pixel: one that is done keeps -T (its T_final)
  float py[kRows], T[kRows], c0[kRows], c1[kRows], c2[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + k * L::kRowStep;
    py[k] = (float)y;
    T[k] = x < width && y < height ? 1.f : -1.f;
    c0[k] = c1[k] = c2[k] = 0.f;
  }
  auto any_live = [&]() {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRows; ++k) any |= T[k] > 0.f;
    return any;
  };

  const int start = tile_start[tile];
  const int end = tile_end[tile];
  for (int base = start; base < end; base += kBatch) {
    const bool any = any_live();
    // also the barrier that frees the staged records of the last batch
    if (__syncthreads_count(any) == 0) break;
    const int n = min(kBatch, end - base);
    if constexpr (kStaged) {
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const float* r = rec + base + j;
        s_rec[0][j] = make_float4(r[0], r[num_rec], r[2 * num_rec],
                                  r[3 * num_rec]);
        if constexpr (kColour) {
          s_rec[1][j] = make_float4(r[4 * num_rec], r[5 * num_rec],
                                    r[6 * num_rec], r[7 * num_rec]);
          s_rec[2][j].x = r[8 * num_rec];
        } else {
          s_rec[1][j] = make_float4(r[4 * num_rec], r[5 * num_rec], 0.f,
                                    0.f);
        }
      }
      __syncthreads();
    }
    // the batch's record j, from shared or (kNoStage) device memory
    auto geo = [&](int j) {
      if constexpr (kStaged) return s_rec[0][j];
      const float* r = rec + base + j;
      return make_float4(r[0], r[num_rec], r[2 * num_rec], r[3 * num_rec]);
    };
    auto mid = [&](int j) {
      if constexpr (kStaged) return s_rec[1][j];
      const float* r = rec + base + j;
      return make_float4(r[4 * num_rec], r[5 * num_rec], r[6 * num_rec],
                         r[7 * num_rec]);
    };
    auto blue = [&](int j) {
      if constexpr (kStaged) return s_rec[2][j].x;
      return rec[8 * num_rec + base + j];
    };
    if (!__any_sync(kFull, any)) continue;

    for (int q = 0; q < n; q += 32) {
      // the next 32 records that may reach this warp's rectangle
      const int jl = q + lane;
      bool keep = false;
      if (jl < n) {
        const float4 g = geo(jl), m = mid(jl);
        keep = !cull_rect(g.x, g.y, g.z, g.w, m.x, m.y, rx0f, rx1f, ry0f,
                          ry1f);
      }
      for (unsigned bits = __ballot_sync(kFull, keep); bits;
           bits &= bits - 1) {
        const int j = q + __ffs(bits) - 1;
        const float4 g = geo(j), m = mid(j);
        const float mx = g.x, my = g.y, ca = g.z, cb = g.w;
        const float cc = m.x, op = m.y;
        const float bl = kColour ? blue(j) : 0.f;
        const float dx = mx - px;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (!(T[k] > 0.f)) continue;
          const float dy = my - py[k];
          const float power =
              -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          // exp runs whether or not power > 0: the warp runs it for any
          // lane that needs it, and a NaN power fails both tests
          const float alpha = fminf(alpha_max, op * expf(power));
          if (!(power <= 0.f && alpha >= alpha_min)) continue;
          if constexpr (kVariant == kNoScan) {
            c0[k] = c0[k] + m.z * alpha;
            c1[k] = c1[k] + m.w * alpha;
            c2[k] = c2[k] + bl * alpha;
            if (alpha > noscan_stop) T[k] = -T[k];
            continue;
          }
          const float test_t = T[k] * (1.f - alpha);
          if (test_t < t_eps) {
            T[k] = -T[k];
            continue;
          }
          if constexpr (kColour) {
            const float w = alpha * T[k];
            c0[k] = c0[k] + m.z * w;
            c1[k] = c1[k] + m.w * w;
            c2[k] = c2[k] + bl * w;
          }
          T[k] = test_t;
        }
      }
      if (!__any_sync(kFull, any_live())) break;
    }
  }

  const long long plane = (long long)hp * wp;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long idx = (long long)(y0 + k * L::kRowStep) * wp + x;
    rgb[idx] = c0[k];
    rgb[plane + idx] = c1[k];
    rgb[2 * plane + idx] = c2[k];
    t_final[idx] = fabsf(T[k]);
  }
}

// rec: [9, num_rec] float32 SoA records, tile segments in depth order;
// tile_start/tile_end: [tiles_x * tiles_y] int32; rgb: [3, Hp, Wp];
// t_final: [Hp, Wp], Hp = kTile tiles_y, Wp = kTile tiles_x.  Launches on
// `stream` and returns cudaGetLastError().
template <int kTile, int kBlock, int kMinBlocks, int kVariant = kFullBlend>
int launch_fwd(const float* rec, long long num_rec, const int* tile_start,
               const int* tile_end, int tiles_x, int tiles_y, int height,
               int width, float* rgb, float* t_final, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    fwd_kernel<kTile, kBlock, kMinBlocks, kVariant>
        <<<num_tiles, kBlock, 0, (cudaStream_t)stream>>>(
            rec, num_rec, tile_start, tile_end, tiles_x, tiles_y, height,
            width, rgb, t_final);
  }
  return (int)cudaGetLastError();
}

}  // namespace raster_tile
