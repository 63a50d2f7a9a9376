// Tile alpha-blend forward on the 16 px grid (the v3 configuration,
// SPLATCO_RASTER=v3).
//
// Replaces the TPU kernel `_fwd_kernel_q` of splatco_tpu/ops/raster_v3.py
// (launched by `forward_pallas_v3`).  It computes the same function: every
// pixel of a 16x16 tile walks the tile's depth-sorted records front to
// back under the blend contract, over the 16 px binning's segments.  The
// TPU kernel walks the four subtiles of a 32 px parent side by side in
// 128-record windows cut out with `pltpu.roll`, with a log-depth cumprod;
// all of that is TPU machinery.  Here one block takes one 16x16 tile
// (raster_tile.cuh).  Pixels beyond H x W start done, and a tile with no
// records writes rgb 0 and T 1: the JAX `parent_nonempty` default.
//
// What bounds it: the fp32 and SFU issue rate, ~16 operations and one
// exp per pixel evaluation, 75 % of which contribute at render frame 0.
// Chosen by timing variants of the template at that frame (1600x1088,
// ~554 records a tile; H100 80GB HBM3, 700 W), where the first layout
// (256 threads, one pixel each) took 1.01 ms: 128 threads a tile, 4 warps
// of 8 x 8 pixels (2 a lane; capped, 1 a lane: 1.12 ms, 4 a lane: 0.93),
// the records culled per warp (16 % of (record, warp) pairs skipped, 3 %
// of the time), registers capped for 10 blocks an SM (48 registers, 44 B
// of spill stores), liveness in T's sign (0.85 -> 0.80 ms) and one shared
// array with the blue read once a record: 0.76 ms.  Tiles in launch
// order: heaviest-first needs an order argument for 7 %; cp.async
// double-buffering of the next batch paid 1 % (PERF.md).  No atomics.
#include "raster_tile.cuh"

extern "C" int raster_fwd16(const float* rec, long long num_rec,
                            const int* tile_start, const int* tile_end,
                            int tiles_x, int tiles_y, int height, int width,
                            float* rgb, float* t_final, void* stream) {
  return raster_tile::launch_fwd<16, 128, 10>(rec, num_rec, tile_start,
                                              tile_end, tiles_x, tiles_y,
                                              height, width, rgb, t_final,
                                              stream);
}
