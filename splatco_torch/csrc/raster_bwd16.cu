// Tile alpha-blend backward on the 16 px grid (the v3 configuration,
// SPLATCO_RASTER=v3).
//
// Replaces the TPU kernel `_bwd_kernel_q` of splatco_tpu/ops/raster_v3.py
// (launched by `backward_pallas_v3`).  It computes the per-record
// gradients (mx, my, ca, cb, cc, op, r, g, b) of the blended image for its
// cotangent, in record order.  The TPU kernel emits (slot key, grads) rows
// in parent-quad walk order for two key sorts to put back; here the
// records stay in binning order and ops/rasterize.py reduces them per
// gaussian through the binning's slot map.
//
// What bounds it: the fp32 instruction rate.  At a training view of the
// quick-start model (1600x1088, ~388 records a tile) the design this
// replaces (one 256-thread block a tile, one pixel a thread) spent 77 % of
// its 3.26 ms in the per-record warp butterflies (0.74 ms without them): a
// 9-value butterfly per 32 pixels.  Chosen, by timing variants at that view
// on an H100 (700 W): 64 threads a tile, 2 warps of 16 x 8 pixels (4 a lane,
// summed in the lane before any shuffle; 1 pixel a lane: 2.54 ms, 2: 1.77,
// one warp of 8: 1.82), the records culled per warp (8 % of pairs skipped),
// groups of kGroup = 2 (R = 4 needs spills at this cap, 8 and 16: 2.80 and
// 5.19 ms uncapped), registers capped for 12 blocks an SM: 1.64 ms with a
// fast division and fused prefix, 1.77 ms with the plain version's
// arithmetic, which is kept (80 registers, 10 B of spill stores, 13,856 B of
// shared memory).  Tiles in launch order: heavy-first cost a sort and an
// order argument for a 4-5 % gain (see PERF.md).  A batch's record load (~1
// us) is not double-buffered: the other blocks on the SM hide it.  No
// atomics.
#include "raster_bwd_tile.cuh"

extern "C" int raster_bwd16(const float* rec, long long num_rec,
                            const int* tile_start, const int* tile_end,
                            int tiles_x, int tiles_y, int height, int width,
                            const float* grad, const float* rgb,
                            const float* t_final, const float* bg,
                            float* out, void* stream) {
  return raster_tile::launch_bwd<16, 64, 12>(
      rec, num_rec, tile_start, tile_end, tiles_x, tiles_y, height, width,
      grad, rgb, t_final, bg, out, stream);
}
