"""Differentiable rasterization entry point (counterpart of
splatco_tpu/ops/rasterize.py).

Two configurations, as in the JAX package: the 32 px tiles of v2 (the
default) and the 16 px tiles of v3 (ops/raster_v3.py), chosen per call by
`tile16` or, when that is None, by SPLATCO_RASTER=v3 at import
(`TILE16_DEFAULT`).  Both run the same steps at their tile size:

  forward : tile binning (ops/binning.py: its three kernels, inside
            `record_function("binning")`) + the blend kernel
            (`raster_fwd` / `raster_fwd16`), then image = rgb + bg *
            T_final cropped to H x W,
  backward: the blend's backward kernel (`raster_bwd` / `raster_bwd16`)
            -> per-record gradients [9, P] -> summed per gaussian through
            the binning's slot map, over the slots its slot mask holds,
            j = 0 .. kmax-1 in order (`reduce_slots`: the `slot_reduce`
            kernel of csrc/slot_reduce.cu, inside
            `record_function("slot_reduce")`): a deterministic
            per-gaussian reduce with no index_add_, scatter or float
            atomic.

Gradients flow to the means (mx, my), conics, colours, opacities and bg.
The binning (tile assignment, depth order) is not differentiated, and
depth and radius get no gradient, as in the JAX package.  The
densification statistics read dL/d(mx, my) through a zero "viewspace
proxy" the caller adds to the means.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch

from splatco_torch.ops import binning, cuda_lib, raster_v3
from splatco_torch.ops.binning import NUM_REC, TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize_cuda import raster_bwd, raster_fwd

REDUCE_KERNEL = "slot_reduce"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
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


def reduce_slots_plain(per_record: torch.Tensor, slot_pos: torch.Tensor,
                       slot_mask: torch.Tensor) -> torch.Tensor:
    """Per-gaussian sums [9, N] of per-record rows [9, P]: for each slot
    rank j = 0 .. kmax-1 in turn, the rows gathered through the slot map
    [N, kmax] where the slot mask has j's bit (+0.0 where it has not)
    added to the running sums, which start at +0.0.  The fixed order is
    what `slot_reduce` repeats bit for bit."""
    n, kmax = slot_pos.shape
    out = per_record.new_zeros((per_record.shape[0], n))
    if per_record.shape[1] == 0:
        return out
    held = binning.slot_bits(slot_mask, kmax)
    for j in range(kmax):
        pos = torch.where(held[:, j], slot_pos[:, j], 0).long()
        out = out + torch.where(held[:, j], per_record[:, pos], 0.0)
    return out


def reduce_slots(per_record: torch.Tensor, slot_pos: torch.Tensor,
                 slot_mask: torch.Tensor) -> torch.Tensor:
    """Per-gaussian sums [9, N] of per-record rows [9, P] through the slot
    map [N, kmax] under the slot mask [ceil(kmax / 32), N], summed over
    the slots in order: `csrc/slot_reduce.cu` for CUDA tensors,
    `reduce_slots_plain` for CPU ones."""
    dev = per_record.device
    if dev.type == "cpu":
        return reduce_slots_plain(per_record, slot_pos, slot_mask)
    n, kmax = slot_pos.shape
    if dev.type != "cuda" or per_record.dtype != torch.float32 \
            or per_record.shape[0] != NUM_REC \
            or slot_pos.dtype != torch.int32 or slot_pos.device != dev \
            or slot_mask.dtype != torch.int32 or slot_mask.device != dev \
            or slot_mask.shape != (binning.mask_words(kmax), n):
        raise ValueError(f"{REDUCE_KERNEL} takes [9, P] float32, an int32 "
                         f"slot map [N, kmax] and its int32 mask [ceil(kmax "
                         f"/ 32), N] on one card, got {per_record.dtype} "
                         f"{tuple(per_record.shape)} on {dev}, "
                         f"{slot_pos.dtype} {tuple(slot_pos.shape)} on "
                         f"{slot_pos.device} and {slot_mask.dtype} "
                         f"{tuple(slot_mask.shape)} on {slot_mask.device}")
    rec = per_record.contiguous()
    pos = slot_pos.contiguous()
    mask = slot_mask.contiguous()
    packed = torch.empty((rec.shape[1], 12), dtype=torch.float32, device=dev)
    out = torch.empty((NUM_REC, n), dtype=torch.float32, device=dev)
    fn = cuda_lib.function(REDUCE_KERNEL, (_P, _L, _P, _P, _I, _L, _P, _P,
                                           _P))
    with torch.cuda.device(dev):
        err = fn(rec.data_ptr(), rec.shape[1], pos.data_ptr(),
                 mask.data_ptr(), kmax, n, packed.data_ptr(), out.data_ptr(),
                 cuda_lib.stream(dev))
    cuda_lib.launched(REDUCE_KERNEL, err)
    return out


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
        with torch.profiler.record_function("binning"):
            binned, tiles_x, tiles_y = bin_frame(proj, colors, opacities,
                                                 tile, image_height,
                                                 image_width, kmax)
        rgb, t_fin = raster_fwd(binned.records, binned.tile_start,
                                binned.tile_end, tiles_x, tiles_y,
                                image_height, image_width, tile=tile)
        image = (rgb + bg[:, None, None] * t_fin[None]
                 )[:, :image_height, :image_width]
        aux.update(num_clipped=binned.num_clipped,
                   num_pairs=binned.records.shape[1],
                   max_slots=binned.max_slots, num_overflow=0)
        ctx.save_for_backward(binned.records, binned.tile_start,
                              binned.tile_end, binned.slot_pos,
                              binned.slot_mask, rgb, t_fin, bg)
        ctx.shape = (image_height, image_width, tiles_x, tiles_y, tile)
        return image

    @staticmethod
    def backward(ctx, g_img):
        (records, tile_start, tile_end, slot_pos, slot_mask, rgb, t_fin,
         bg) = ctx.saved_tensors
        h, w, tiles_x, tiles_y, tile = ctx.shape
        gpad = torch.zeros_like(rgb)
        gpad[:, :h, :w] = g_img
        per_rec = raster_bwd(records, tile_start, tile_end, tiles_x,
                             tiles_y, h, w, gpad, rgb, t_fin,
                             bg.detach().contiguous(), tile=tile)
        with torch.profiler.record_function("slot_reduce"):
            per_g = reduce_slots(per_rec, slot_pos, slot_mask)
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
