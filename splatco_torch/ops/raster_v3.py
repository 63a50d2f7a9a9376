"""The v3 rasterizer configuration: 16x16 pixel tiles (counterpart of
splatco_tpu/ops/raster_v3.py, selected by SPLATCO_RASTER=v3).

v3 culls each gaussian to its rect on the 16 px grid, with `kmax` counted
in 16 px tiles, so fringe membership, and with it the image and the
gradients, differ from the 32 px (v2) configuration.  The grid is that of
the JAX package: 32 px parents cover the image and each holds 2x2 tiles,
so tiles_x = 2 * ceil(W / 32), not ceil(W / 16).  That wider grid also
moves the rect clamp, and with it which tiles a clipped gaussian keeps
and `num_clipped`.

  bin_gaussians_v3: the port's binning (ops/binning.py, its CUDA
      kernels on the card) at tile size 16 on that grid: depth-ordered
      per-tile segments, `num_clipped` and `max_slots` as JAX defines
      them, the slot map for the backward.  Tile ids are row-major.  Each
      gaussian's slots are ranked in the JAX package's parent-major tile
      order, as its binning ranks them (`parent_major_slots`, the rank's
      plain version; the kernels rank in csrc/binning.cuh), so gaussians
      at equal depth in one tile (the offsets of one anchor start at one
      point) come in the JAX order.  Its parent-major ids
      themselves, the pad subtiles, class packing, K-aligned tail,
      slot-key record row and step maps exist for its TPU kernels' static
      shapes and block walks; they have no counterpart here.

The blend kernels of the configuration, `csrc/raster_fwd16.cu` and
`csrc/raster_bwd16.cu` (counterparts of `forward_pallas_v3` and
`backward_pallas_v3`), are launched by `raster_fwd` / `raster_bwd` of
ops/rasterize_cuda.py at tile=TILE; their plain versions are that
module's, at the same tile size.
"""
from __future__ import annotations

from typing import Tuple

import torch

from splatco_torch.ops.binning import BinnedGaussians, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols

TILE = 16


def parent_grid(image_height: int, image_width: int) -> Tuple[int, int]:
    """(parents_x, parents_y): 32x32 parent tiles covering the image."""
    return -(-image_width // 32), -(-image_height // 32)


def tile_grid(image_height: int, image_width: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) of the 16 px grid: 2x2 tiles per parent."""
    parents_x, parents_y = parent_grid(image_height, image_width)
    return 2 * parents_x, 2 * parents_y


def bin_gaussians_v3(proj: ProjectedCols, colors: torch.Tensor,
                     opacities: torch.Tensor, tiles_x: int, tiles_y: int,
                     kmax: int = 24) -> BinnedGaussians:
    """Bin projected gaussians into depth-ordered segments of the 16 px
    tiles (`tiles_x`, `tiles_y` from `tile_grid`), each gaussian's slots
    ranked in parent-major tile order: the binning kernels of
    ops/binning.py."""
    return bin_gaussians(proj, colors, opacities, TILE, tiles_x, tiles_y,
                         kmax=kmax, parent_major=True)


def parent_major_slots(tile_of_slot: torch.Tensor, tiles_x: int,
                       num_tiles: int) -> torch.Tensor:
    """Each gaussian's slots [kmax, N] reordered by parent-major tile id
    (the 2x2 tiles of a 32 px parent consecutive), invalid slots
    (`num_tiles`) last: the slot rank JAX `bin_gaussians_v3` emits by."""
    tx = tile_of_slot % tiles_x
    ty = tile_of_slot // tiles_x
    pm = (((ty >> 1) * (tiles_x >> 1) + (tx >> 1)) * 4
          + (ty & 1) * 2 + (tx & 1))
    pm = torch.where(tile_of_slot < num_tiles, pm, num_tiles)
    order = torch.sort(pm, dim=0, stable=True).indices
    return torch.gather(tile_of_slot, 0, order)
