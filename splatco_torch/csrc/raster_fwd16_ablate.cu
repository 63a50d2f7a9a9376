// The 16 px tile blend forward with parts left out, for timing: which
// part of raster_fwd16's time goes to bringing records to the arithmetic,
// the transmittance chain, or the colour sums.
//
// Replaces the TPU kernel `kern` of tools/profile_kernel_v3.py, an
// ablation of the v3 forward with the variants full / noroll / noscan /
// noaccum.  Here the variants are `raster_tile::Variant`, a template
// parameter of the production kernel `fwd_kernel<16>`, so `full` is
// raster_fwd16 itself and each other variant differs from it by one
// `if constexpr` branch:
//   0 full:    raster_fwd16's function (the blend contract, raster_tile.cuh);
//   1 nostage: the same image, every thread reading the records from
//              device memory instead of a shared-memory batch (the
//              counterpart of `noroll`, which skipped the TPU's window cut);
//   2 noscan:  T stays 1, so a contributing record adds colour * alpha; a
//              pixel stops after the first record with alpha > 0.97, that
//              record included; T_final is 1;
//   3 noaccum: the chain and termination as full, no colour sums: rgb 0,
//              T_final as full's.
// What bounds each: as raster_fwd16, fp32 and SFU work per pixel
// evaluation; the timing tool (tools/profile_torch_kernel_v3.py) holds
// every variant to full's bound.
#include "raster_tile.cuh"

extern "C" int raster_fwd16_ablate(int variant, const float* rec,
                                   long long num_rec, const int* tile_start,
                                   const int* tile_end, int tiles_x,
                                   int tiles_y, int height, int width,
                                   float* rgb, float* t_final, void* stream) {
  using namespace raster_tile;
  switch (variant) {
    case kFullBlend:
      return launch_fwd<16, kFullBlend>(rec, num_rec, tile_start, tile_end,
                                        tiles_x, tiles_y, height, width, rgb,
                                        t_final, stream);
    case kNoStage:
      return launch_fwd<16, kNoStage>(rec, num_rec, tile_start, tile_end,
                                      tiles_x, tiles_y, height, width, rgb,
                                      t_final, stream);
    case kNoScan:
      return launch_fwd<16, kNoScan>(rec, num_rec, tile_start, tile_end,
                                     tiles_x, tiles_y, height, width, rgb,
                                     t_final, stream);
    case kNoAccum:
      return launch_fwd<16, kNoAccum>(rec, num_rec, tile_start, tile_end,
                                      tiles_x, tiles_y, height, width, rgb,
                                      t_final, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
