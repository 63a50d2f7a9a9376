// Tile alpha-blend backward on the 32 px grid (the v2 configuration).
//
// Replaces the TPU kernel `_bwd_kernel` of
// splatco_tpu/ops/rasterize_pallas.py (launched by `backward_pallas`).
// It computes the same function: the gradient of the blended image with
// respect to every binned record (mx, my, ca, cb, cc, op, r, g, b), in
// record order.  The TPU kernel's chunk grid, log-depth cumsum and masked
// read-modify-write blocks are TPU machinery; here each lane replays its
// pixels serially, as the forward does (raster_bwd_tile.cuh).
//
// What bounds it: the fp32 instruction rate.  At a training view of the
// quick-start model (1600x1088, ~606 records a tile) the design this
// replaces spent 61 % of its 2.85 ms in the per-record warp butterflies
// (1.10 ms without them).  Chosen, by timing variants at that view on an
// H100 (700 W): 256 threads, 8 warps of 16 x 8 pixels (4 a lane), the
// records culled per warp (35 % of (record, warp) pairs skipped; 4.81 ms
// without, at R = 8), groups of kGroup = 2 (R = 4: 2.00 ms, R = 8 and 16
// need 166-230 registers: 3.70 and 4.37 ms; 128 threads: 2.05 ms), registers
// capped for 3 blocks an SM: 1.91 ms with a fast division and fused prefix,
// 2.07 ms with the plain version's arithmetic, which is kept (80 registers,
// 28 B of spill stores, 41,600 B of shared memory). Tiles in launch order:
// heavy-first cost a sort and an order argument for a 6-10 % gain (see
// PERF.md).  A batch's record load (~1 us) is not double-buffered: the other
// blocks on the SM hide it.  No atomics.
#include "raster_bwd_tile.cuh"

extern "C" int raster_bwd(const float* rec, long long num_rec,
                          const int* tile_start, const int* tile_end,
                          int tiles_x, int tiles_y, int height, int width,
                          const float* grad, const float* rgb,
                          const float* t_final, const float* bg, float* out,
                          void* stream) {
  return raster_tile::launch_bwd<32, 256, 3>(
      rec, num_rec, tile_start, tile_end, tiles_x, tiles_y, height, width,
      grad, rgb, t_final, bg, out, stream);
}
