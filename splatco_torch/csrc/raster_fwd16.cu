// Tile alpha-blend forward on the 16 px grid (the v3 configuration,
// SPLATCO_RASTER=v3).
//
// Replaces the TPU kernel `_fwd_kernel_q` of splatco_tpu/ops/raster_v3.py
// (launched by `forward_pallas_v3`).  It computes the same function: every
// pixel of a 16x16 tile walks the tile's depth-sorted records front to
// back under the blend contract, over the 16 px binning's segments.  The
// TPU kernel walks the four subtiles of a 32 px parent side by side in
// 128-record windows cut out with `pltpu.roll`, with a log-depth cumprod;
// all of that is TPU machinery.  Here one 256-thread block takes one 16x16
// tile, one pixel per thread, records staged through shared memory 256 at
// a time, the serial per-pixel loop and a block early-out
// (raster_tile.cuh).  Pixels beyond H x W start done, and a tile with no
// records writes rgb 0 and T 1: the JAX `parent_nonempty` default.
#include "raster_tile.cuh"

extern "C" int raster_fwd16(const float* rec, long long num_rec,
                            const int* tile_start, const int* tile_end,
                            int tiles_x, int tiles_y, int height, int width,
                            float* rgb, float* t_final, void* stream) {
  return raster_tile::launch_fwd<16>(rec, num_rec, tile_start, tile_end,
                                     tiles_x, tiles_y, height, width, rgb,
                                     t_final, stream);
}
