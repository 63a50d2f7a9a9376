// Tile alpha-blend backward on the 32 px grid (the v2 configuration).
//
// Replaces the TPU kernel `_bwd_kernel` of
// splatco_tpu/ops/rasterize_pallas.py (launched by `backward_pallas`).
// It computes the same function: the gradient of the blended image with
// respect to every binned record (mx, my, ca, cb, cc, op, r, g, b), in
// record order.  The TPU kernel's chunk grid, log-depth cumsum and masked
// read-modify-write blocks are TPU machinery; here each thread replays its
// four pixels serially, as the forward does, and each record's nine sums
// over the tile's 1024 pixels go through warp shuffles and a fixed-order
// sum of the 8 warps' partials (raster_tile.cuh): no atomics.
#include "raster_tile.cuh"

extern "C" int raster_bwd(const float* rec, long long num_rec,
                          const int* tile_start, const int* tile_end,
                          int tiles_x, int tiles_y, int height, int width,
                          const float* grad, const float* rgb,
                          const float* t_final, const float* bg, float* out,
                          void* stream) {
  return raster_tile::launch_bwd<32>(rec, num_rec, tile_start, tile_end,
                                     tiles_x, tiles_y, height, width, grad,
                                     rgb, t_final, bg, out, stream);
}
