"""Rasterization entry point, forward only (counterpart of the forward of
splatco_tpu/ops/rasterize.py): tile binning (ops/binning.py) + the blend
kernel (ops/rasterize_cuda.py), then image = rgb + bg * T_final cropped to
H x W.  The backward comes with the training slice."""
from __future__ import annotations

import torch

from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize_cuda import raster_fwd


def tile_grid(image_height: int, image_width: int):
    """(tiles_x, tiles_y) of the 32 px grid covering the image."""
    return -(-image_width // TILE), -(-image_height // TILE)


def rasterize(proj: ProjectedCols, colors: torch.Tensor,
              opacities: torch.Tensor, bg: torch.Tensor, image_height: int,
              image_width: int, kmax: int = 12, return_aux: bool = False):
    """Render projected gaussians -> image [3,H,W].  With return_aux=True
    also returns the binning counters: num_clipped (gaussians whose rect
    was clipped to kmax tiles: the image is approximate there), num_pairs
    (the (tile, gaussian) records blended), max_slots and num_overflow
    (always 0: there is no static slot budget to overflow)."""
    tiles_x, tiles_y = tile_grid(image_height, image_width)
    binned = bin_gaussians(proj, colors, opacities, TILE, tiles_x, tiles_y,
                           kmax=kmax)
    rgb, t_fin = raster_fwd(binned.records, binned.tile_start,
                            binned.tile_end, tiles_x, tiles_y, image_height,
                            image_width)
    image = (rgb + bg[:, None, None] * t_fin[None]
             )[:, :image_height, :image_width]
    if not return_aux:
        return image
    aux = {
        "num_clipped": binned.num_clipped,
        "num_pairs": binned.records.shape[1],
        "max_slots": binned.max_slots,
        "num_overflow": 0,
    }
    return image, aux
