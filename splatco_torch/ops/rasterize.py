"""Differentiable rasterization entry point (counterpart of
splatco_tpu/ops/rasterize.py).

Two configurations, as in the JAX package: the 32 px tiles of v2 (the
default) and the 16 px tiles of v3 (ops/raster_v3.py), chosen per call by
`tile16` or, when that is None, by SPLATCO_RASTER=v3 at import
(`TILE16_DEFAULT`).  Both run the same steps at their tile size:

  forward : tile binning (ops/binning.py) + the blend kernel
            (`raster_fwd` / `raster_fwd16`), then image = rgb + bg *
            T_final cropped to H x W,
  backward: the blend's backward kernel (`raster_bwd` / `raster_bwd16`)
            -> per-record gradients [9, P] -> gathered into [9, kmax, N]
            through the binning's slot map (zeros where a slot has no
            record) and summed over the slots: a deterministic
            per-gaussian reduce with no index_add_, scatter or float
            atomic.

Gradients flow to the means (mx, my), conics, colours, opacities and bg.
The binning (tile assignment, depth order) is not differentiated, and
depth and radius get no gradient, as in the JAX package.  The
densification statistics read dL/d(mx, my) through a zero "viewspace
proxy" the caller adds to the means.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from splatco_torch.ops import raster_v3
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize_cuda import raster_bwd, raster_fwd

# the configuration a call takes when it passes tile16=None:
# SPLATCO_RASTER=v3 -> 16 px tiles, anything else -> 32 px
TILE16_DEFAULT = os.environ.get("SPLATCO_RASTER", "v2") == "v3"


def tile_grid(image_height: int, image_width: int):
    """(tiles_x, tiles_y) of the 32 px grid covering the image."""
    return -(-image_width // TILE), -(-image_height // TILE)


def bin_frame(proj: ProjectedCols, colors, opacities, tile: int,
              image_height: int, image_width: int, kmax: int):
    """The binning `rasterize` runs at pixel tile size `tile` (32 or 16):
    (binned, tiles_x, tiles_y)."""
    if tile == raster_v3.TILE:
        tiles_x, tiles_y = raster_v3.tile_grid(image_height, image_width)
        return (raster_v3.bin_gaussians_v3(proj, colors, opacities, tiles_x,
                                           tiles_y, kmax=kmax),
                tiles_x, tiles_y)
    tiles_x, tiles_y = tile_grid(image_height, image_width)
    return (bin_gaussians(proj, colors, opacities, TILE, tiles_x, tiles_y,
                          kmax=kmax), tiles_x, tiles_y)


def reduce_slots(per_record: torch.Tensor, slot_pos: torch.Tensor
                 ) -> torch.Tensor:
    """Per-gaussian sums [9, N] of per-record rows [9, P]: gather through
    the slot map [kmax, N] (-1 = no record) and sum over the slots."""
    if per_record.shape[1] == 0:
        return per_record.new_zeros((per_record.shape[0], slot_pos.shape[1]))
    gathered = per_record[:, slot_pos.clamp_min(0)]      # [9, kmax, N]
    return torch.where(slot_pos[None] >= 0, gathered, 0.0).sum(dim=1)


class _Rasterize(torch.autograd.Function):
    """The blend with its hand-written backward (the counterpart of the
    JAX package's `jax.custom_vjp`) at pixel tile size `tile` (32 or 16).
    `aux` is a dict the forward fills with the binning counters."""

    @staticmethod
    def forward(ctx, mx, my, ca, cb, cc, colors, opacities, depth, radius,
                bg, image_height: int, image_width: int, kmax: int,
                tile: int, aux: Dict):
        proj = ProjectedCols(mx=mx, my=my, depth=depth, ca=ca, cb=cb, cc=cc,
                             radius=radius)
        binned, tiles_x, tiles_y = bin_frame(proj, colors, opacities, tile,
                                             image_height, image_width, kmax)
        rgb, t_fin = raster_fwd(binned.records, binned.tile_start,
                                binned.tile_end, tiles_x, tiles_y,
                                image_height, image_width, tile=tile)
        image = (rgb + bg[:, None, None] * t_fin[None]
                 )[:, :image_height, :image_width]
        aux.update(num_clipped=binned.num_clipped,
                   num_pairs=binned.records.shape[1],
                   max_slots=binned.max_slots, num_overflow=0)
        ctx.save_for_backward(binned.records, binned.tile_start,
                              binned.tile_end, binned.slot_pos, rgb, t_fin,
                              bg)
        ctx.shape = (image_height, image_width, tiles_x, tiles_y, tile)
        return image

    @staticmethod
    def backward(ctx, g_img):
        records, tile_start, tile_end, slot_pos, rgb, t_fin, bg = \
            ctx.saved_tensors
        h, w, tiles_x, tiles_y, tile = ctx.shape
        gpad = torch.zeros_like(rgb)
        gpad[:, :h, :w] = g_img
        per_rec = raster_bwd(records, tile_start, tile_end, tiles_x,
                             tiles_y, h, w, gpad, rgb, t_fin,
                             bg.detach().contiguous(), tile=tile)
        per_g = reduce_slots(per_rec, slot_pos)
        d_bg = (g_img * t_fin[None, :h, :w]).sum(dim=(1, 2))
        d_colors = per_g[6:9].T.contiguous()
        return (per_g[0], per_g[1], per_g[2], per_g[3], per_g[4], d_colors,
                per_g[5], None, None, d_bg, None, None, None, None, None)


def rasterize(proj: ProjectedCols, colors: torch.Tensor,
              opacities: torch.Tensor, bg: torch.Tensor, image_height: int,
              image_width: int, kmax: int = 12, return_aux: bool = False,
              tile16: Optional[bool] = None):
    """Render projected gaussians -> image [3,H,W], differentiable w.r.t.
    the means, conics, colours, opacities and bg.  With return_aux=True
    also returns the binning counters: num_clipped (gaussians whose rect
    was clipped to kmax tiles: the image is approximate there), num_pairs
    (the (tile, gaussian) records blended), max_slots and num_overflow
    (always 0: there is no static slot budget to overflow).

    tile16 picks the v3 configuration (16 px tiles, `kmax` counted in
    16 px tiles) or v2 (32 px); None reads `TILE16_DEFAULT` at call
    time."""
    if tile16 is None:
        tile16 = TILE16_DEFAULT
    tile = raster_v3.TILE if tile16 else TILE
    aux: Dict = {}
    image = _Rasterize.apply(proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                             colors, opacities, proj.depth,
                             proj.radius.to(torch.float32), bg,
                             image_height, image_width, kmax, tile, aux)
    if not return_aux:
        return image
    return image, aux
