// Tile alpha-blend forward on the 32 px grid (the v2 configuration).
//
// Replaces the TPU kernel `_fwd_kernel` of
// splatco_tpu/ops/rasterize_pallas.py (launched by `forward_pallas`).
// It computes the same function: every pixel of a 32x32 tile walks the
// tile's depth-sorted records front to back under the blend contract.
// The TPU kernel's log-depth cumprod over 128-record chunks is TPU
// machinery; here each lane runs the serial per-pixel loop, the CUDA
// 3DGS form (raster_tile.cuh).
//
// What bounds it: the fp32 and SFU issue rate, ~16 operations and one
// exp per pixel evaluation.  Chosen by timing variants of the template at
// render frame 0 of the quick-start model (1600x1088, ~889 records a
// tile; H100 80GB HBM3, 700 W), where the first layout (one pixel row a
// warp, 256 threads) took 1.43-1.45 ms: 512 threads a tile, 16 warps of
// 8 x 8 pixels (2 a lane; 4 a lane: 1.07-1.09 ms, 1 a lane: 1.27), the
// records culled per warp (40 % of (record, warp) pairs skipped; 1.24 ms
// without, 1.00 with), registers capped for 3 blocks an SM (40 registers,
// 76 B of spill stores; uncapped, 4 pixels a lane took 91 registers and
// 1.50 ms), then liveness in T's sign (0.92 ms) and one shared array with
// the blue read once a record: 0.88 ms.  Tiles in launch order:
// heaviest-first needs an order argument for 7 %; cp.async
// double-buffering of the next batch paid 1 % (PERF.md).  No atomics.
#include "raster_tile.cuh"

extern "C" int raster_fwd(const float* rec, long long num_rec,
                          const int* tile_start, const int* tile_end,
                          int tiles_x, int tiles_y, int height, int width,
                          float* rgb, float* t_final, void* stream) {
  return raster_tile::launch_fwd<32, 512, 3>(rec, num_rec, tile_start,
                                             tile_end, tiles_x, tiles_y,
                                             height, width, rgb, t_final,
                                             stream);
}
