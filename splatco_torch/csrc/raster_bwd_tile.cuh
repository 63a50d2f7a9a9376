// Tile alpha-blend backward for NVIDIA Hopper (sm_90a), templated on the
// pixel tile's side: 32 (the v2 configuration, raster_bwd.cu) or 16 (the
// v3 configuration, raster_bwd16.cu).  The blend contract and the forward
// are in raster_tile.cuh.
//
// The function: the gradient of the blended image with respect to every
// record, given the image's cotangent g, the forward's rgb (no
// background) and T_final.  Per pixel gtot = sum_c rgb_c g_c + (sum_c
// bg_c g_c) T_final; the replay repeats fwd_kernel's arithmetic op for op,
// so a pixel terminates at the same record, and for each contributing
// record (w = alpha T_before):
//   gc = sum_c col_c g_c;  prefix += gc w;
//   dalpha = gc T_before - (gtot - prefix) / max(1 - alpha, 0.01);
//   dpower = alpha < 0.99 ? dalpha alpha : 0.
// Nine per-record sums over the tile's pixels (dp, dp dx, dp dy, dp dx dx,
// dp dx dy, dp dy dy, g_c w) give the record's gradients: d_mx = -(ca Sx +
// cb Sy), d_my = -(cb Sx + cc Sy), d_ca = -Sxx / 2, d_cb = -Sxy, d_cc =
// -Syy / 2, d_op = S / max(op, 1e-12), and the colour sums.
//
// What bounds it on an H100: fp32 and SFU work (~16 operations and one
// exp per pixel evaluation, ~35 per contribution) and, in the design this
// replaces, the per-record sums over pixels: one 9-value warp butterfly
// (45 shuffles, which run at a quarter of the fp32 rate) per record and
// warp, 2-4x the arithmetic it reduced at 16 px.  The design:
//  - Each warp owns a compact pixel rectangle (kRectW x kRectH; a lane owns
//    one column of it, kRows pixels), so a record that cannot reach the
//    rectangle can be recognised once per warp: `cull_rect` (in
//    raster_tile.cuh, shared with the forward), a conservative float32
//    test against the 1/255 contour.  When a batch of records is staged,
//    each warp tests 128 of them (4 per lane) and keeps a bitmask; it then
//    walks only the set bits (__ffs).  A warp with no live pixel keeps an
//    empty mask.  Skipping is exact: a skipped record changes neither T
//    nor any sum.
//  - The walk takes the set bits kGroup at a time.  Each lane keeps its
//    nine partial sums for each record of the group in registers; the warp
//    then reduces the group by a reduce-scatter butterfly (each level a
//    lane sends the half of its records its partner keeps and adds the
//    other half), log2(kGroup) levels, then the 5 - log2(kGroup) levels
//    left on one value: kGroup - 1 + 5 - log2(kGroup) shuffles per sum for
//    kGroup records instead of 5 kGroup.  One lane per record parks the
//    warp's partials in shared memory.
//  - kMinBlocks caps the registers so that many blocks share an SM: the
//    kernel is bound by its instruction rate, and the per-lane partial
//    sums of a group cost 9 kGroup registers.
//  - After the batch one thread per record adds the warps' partials in
//    warp order (a warp that skipped the record adds +0, as a warp with no
//    hit did before) and writes the record's gradients.  Every sum has a
//    fixed order; there are no atomics, so launches are bit-identical.
// The block stops once no pixel is live; records after that keep the zeros
// the wrapper's output starts with.  The replay's power / alpha / T (1 -
// alpha) stay unfused (--fmad=false), and so do gc, the prefix and dL/d
// alpha, whose total - prefix cancels and is then scaled by up to 100;
// only the nine running sums use explicit fma.
#pragma once

#include "raster_tile.cuh"

namespace raster_tile {

constexpr int kSums = 9;  // S, Sx, Sy, Sxx, Sxy, Syy, Sr, Sg, Sb
// records reduced together (R): at a training view on an H100, R = 2
// beat R = 1 by 12-21 %; R = 4 tied or lost (spills under the register
// cap), 8 and 16 lost to their 9 R registers of partial sums
constexpr int kGroup = 2;

// Reduce the lanes' partial sums s[r][c] of kN records (a power of 2 up
// to 32): afterwards s[0][c] of a lane holds the warp's sum for record
// `group_slot<kN>(lane)`.
template <int kN>
__device__ __forceinline__ void reduce_group(float (&s)[kN][kSums],
                                             int lane) {
  constexpr int kLevels = kN == 1 ? 0 : kN == 2 ? 1 : kN == 4 ? 2
                          : kN == 8 ? 3 : kN == 16 ? 4 : 5;
  static_assert((1 << kLevels) == kN && kLevels <= 5, "kN");
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int half = kN >> (lv + 1);
    const int off = 16 >> lv;
    const bool up = lane & off;  // keeps the upper half
#pragma unroll
    for (int i = 0; i < half; ++i) {
#pragma unroll
      for (int c = 0; c < kSums; ++c) {
        const float send = up ? s[i][c] : s[i + half][c];
        const float keep = up ? s[i + half][c] : s[i][c];
        s[i][c] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
  }
#pragma unroll
  for (int off = 16 >> kLevels; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < kSums; ++c)
      s[0][c] = s[0][c] + __shfl_xor_sync(kFull, s[0][c], off);
  }
}

// The record of the group whose sum reduce_group leaves in `lane`.
template <int kN>
__device__ __forceinline__ int group_slot(int lane) {
  int r = 0;
#pragma unroll
  for (int b = 16; b > 16 / kN; b /= 2) r = 2 * r + ((lane & b) ? 1 : 0);
  return r;
}

template <int kTile, int kBlock, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
bwd_kernel(const float* __restrict__ rec, long long num_rec,
           const int* __restrict__ tile_start,
           const int* __restrict__ tile_end, int tiles_x, int height,
           int width, const float* __restrict__ grad,
           const float* __restrict__ rgb, const float* __restrict__ t_final,
           const float* __restrict__ bg, float* __restrict__ out) {
  using L = WarpLayout<kTile, kBlock>;
  constexpr int kRows = L::kRows;
  constexpr int kWarpsB = L::kWarps;
  constexpr int kBatch = 128;  // records staged at once
  constexpr int kWords = kBatch / 32;
  // the same float32 constants as the plain version's Python scalars
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.99;
  const float t_eps = (float)1e-4;
  const float one_m_min = (float)(1.0 - 0.99);
  const float op_min = (float)1e-12;

  __shared__ float s_rec[kRec][kBatch];
  __shared__ float s_part[kWarpsB][kSums][kBatch];
  __shared__ unsigned s_mask[kWarpsB][kWords];

  const int tile = blockIdx.x;
  const int wp = tiles_x * kTile;
  const int hp = (gridDim.x / tiles_x) * kTile;
  const long long plane = (long long)hp * wp;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rx0 = (tile % tiles_x) * kTile + (warp % L::kWarpsX) * L::kRectW;
  const int ry0 = (tile / tiles_x) * kTile + (warp / L::kWarpsX) * L::kRectH;
  const int x = rx0 + lane % L::kRectW;
  const int y0 = ry0 + lane / L::kRectW;
  const float px = (float)x;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];

  float py[kRows], T[kRows], prefix[kRows], gtot[kRows];
  float g0[kRows], g1[kRows], g2[kRows];
  bool live[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + k * L::kRowStep;
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
  const float rx1 = (float)(rx0 + L::kRectW - 1);
  const float ry1 = (float)(ry0 + L::kRectH - 1);

  const int start = tile_start[tile];
  const int end = tile_end[tile];
  for (int base = start; base < end; base += kBatch) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRows; ++k) any |= live[k];
    // also the barrier that frees s_rec, s_part and s_mask of the last batch
    if (__syncthreads_count(any) == 0) break;
    const int n = min(kBatch, end - base);
    for (int j = threadIdx.x; j < n; j += kBlock) {
#pragma unroll
      for (int c = 0; c < kRec; ++c) s_rec[c][j] = rec[c * num_rec + base + j];
    }
    __syncthreads();

    // this warp's records of the batch: those that may reach its rectangle
    const bool warp_live = __any_sync(kFull, any);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int j = q * 32 + lane;
      const bool keep =
          warp_live && j < n
          && !cull_rect(s_rec[0][j], s_rec[1][j], s_rec[2][j], s_rec[3][j],
                        s_rec[4][j], s_rec[5][j], (float)rx0, rx1, (float)ry0,
                        ry1);
      const unsigned m = __ballot_sync(kFull, keep);
      if (lane == 0) s_mask[warp][q] = m;
    }
    __syncwarp();

    int q = 0;
    unsigned bits = s_mask[warp][0];
    for (;;) {
      // the next kGroup set bits, in record order (-1: none left)
      int jr[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        while (bits == 0 && q + 1 < kWords) bits = s_mask[warp][++q];
        jr[r] = bits ? q * 32 + __ffs(bits) - 1 : -1;
        bits &= bits - 1;
      }
      if (jr[0] < 0) break;
      float s[kGroup][kSums];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) s[r][c] = 0.f;
      }
      bool hit = false;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int j = jr[r];
        if (j < 0) break;
        const float mx = s_rec[0][j], my = s_rec[1][j];
        const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
        const float op = s_rec[5][j];
        const float cr = s_rec[6][j], cg = s_rec[7][j], cbl = s_rec[8][j];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (!live[k]) continue;
          const float dx = mx - px;
          const float dy = my - py[k];
          const float power =
              -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
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
          s[r][0] = s[r][0] + dp;
          s[r][1] = s[r][1] + dpx;
          s[r][2] = s[r][2] + dpy;
          s[r][3] = __fmaf_rn(dpx, dx, s[r][3]);
          s[r][4] = __fmaf_rn(dpx, dy, s[r][4]);
          s[r][5] = __fmaf_rn(dpy, dy, s[r][5]);
          s[r][6] = __fmaf_rn(g0[k], w, s[r][6]);
          s[r][7] = __fmaf_rn(g1[k], w, s[r][7]);
          s[r][8] = __fmaf_rn(g2[k], w, s[r][8]);
          T[k] = test_t;
          hit = true;
        }
      }
      // with no hit in the warp every partial is +0 already
      if (__any_sync(kFull, hit)) reduce_group<kGroup>(s, lane);
      const int slot = group_slot<kGroup>(lane);
      int j = jr[0];
#pragma unroll
      for (int r = 1; r < kGroup; ++r) j = slot == r ? jr[r] : j;
      if ((lane & (32 / kGroup - 1)) == 0 && j >= 0) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) s_part[warp][c][j] = s[0][c];
      }
      if (jr[kGroup - 1] < 0) break;
    }
    __syncthreads();

    for (int j = threadIdx.x; j < n; j += kBlock) {
      float r[kSums];
#pragma unroll
      for (int c = 0; c < kSums; ++c) r[c] = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarpsB; ++wi) {
        const bool has = (s_mask[wi][j / 32] >> (j % 32)) & 1u;
#pragma unroll
        for (int c = 0; c < kSums; ++c) {
          const float v = has ? s_part[wi][c][j] : 0.f;
          r[c] = wi == 0 ? v : r[c] + v;
        }
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
// tile_start/tile_end: [tiles_x * tiles_y] int32; grad, rgb: [3, Hp, Wp];
// t_final: [Hp, Wp], Hp = kTile tiles_y, Wp = kTile tiles_x; bg: [3];
// out: [9, num_rec], zero-filled by the caller.  Launches on `stream` and
// returns cudaGetLastError().
template <int kTile, int kBlock, int kMinBlocks>
int launch_bwd(const float* rec, long long num_rec, const int* tile_start,
               const int* tile_end, int tiles_x, int tiles_y, int height,
               int width, const float* grad, const float* rgb,
               const float* t_final, const float* bg, float* out,
               void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    bwd_kernel<kTile, kBlock, kMinBlocks>
        <<<num_tiles, kBlock, 0, (cudaStream_t)stream>>>(
            rec, num_rec, tile_start, tile_end, tiles_x, height, width, grad,
            rgb, t_final, bg, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace raster_tile
