// Tile alpha-blend backward on the 16 px grid (the v3 configuration,
// SPLATCO_RASTER=v3).
//
// Replaces the TPU kernel `_bwd_kernel_q` of splatco_tpu/ops/raster_v3.py
// (launched by `backward_pallas_v3`).  It computes the per-record
// gradients (mx, my, ca, cb, cc, op, r, g, b) of the blended image for its
// cotangent, in record order.  The TPU kernel emits (slot key, grads) rows
// in parent-quad walk order for two key sorts to put back; here the
// records stay in binning order and ops/rasterize.py reduces them per
// gaussian through the binning's slot map.  One 256-thread block per
// 16x16 tile, one pixel per thread: the forward's replay op for op, dL/d
// alpha from total - prefix, each record's nine sums over the 256 pixels
// by an xor-shuffle butterfly per warp, then the 8 warps' partials added
// in warp order (raster_tile.cuh).  No atomics.
#include "raster_tile.cuh"

extern "C" int raster_bwd16(const float* rec, long long num_rec,
                            const int* tile_start, const int* tile_end,
                            int tiles_x, int tiles_y, int height, int width,
                            const float* grad, const float* rgb,
                            const float* t_final, const float* bg,
                            float* out, void* stream) {
  return raster_tile::launch_bwd<16>(rec, num_rec, tile_start, tile_end,
                                     tiles_x, tiles_y, height, width, grad,
                                     rgb, t_final, bg, out, stream);
}
