// Tile alpha-blend forward on the 32 px grid (the v2 configuration).
//
// Replaces the TPU kernel `_fwd_kernel` of
// splatco_tpu/ops/rasterize_pallas.py (launched by `forward_pallas`).
// It computes the same function: every pixel of a 32x32 tile walks the
// tile's depth-sorted records front to back under the blend contract.
// The TPU kernel's log-depth cumprod over 128-record chunks is TPU
// machinery; here each thread runs the serial per-pixel loop, the CUDA
// 3DGS form.  The kernel, its layout (256 threads, four pixels of one
// column each) and what bounds it are in raster_tile.cuh.
#include "raster_tile.cuh"

extern "C" int raster_fwd(const float* rec, long long num_rec,
                          const int* tile_start, const int* tile_end,
                          int tiles_x, int tiles_y, int height, int width,
                          float* rgb, float* t_final, void* stream) {
  return raster_tile::launch_fwd<32>(rec, num_rec, tile_start, tile_end,
                                     tiles_x, tiles_y, height, width, rgb,
                                     t_final, stream);
}
