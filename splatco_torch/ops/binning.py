"""Tile binning (counterpart of splatco_tpu/ops/binning.py) on the 32 px
grid of the v2 configuration, or at any tile size: ops/raster_v3.py bins
the v3 configuration's 16 px grid with the same steps.

  1. per-gaussian tile rects, clipped to `kmax` tiles around the centre
     (`_rects`, identical to the JAX package's, with the `num_clipped`
     count),
  2. the [kmax, N] j-major slot grid with the exact ellipse-reach test
     (`_slot_grid`, identical to the JAX package's): a dropped slot has
     max alpha < 1/255 over its tile, which the blend skips anyway,
  3. only the valid (tile, gaussian) pairs are emitted — a dynamic count,
     no static slot budget — and sorted stably by one 64-bit key
     `tile << 32 | float_bits(depth)` (depth is positive past the near
     clip, so its bits order like the value).  Emission is j-major, as
     the JAX slot array is, so depth ties break the same way,
  4. the 9 record columns are gathered into SoA [9, P] float32 and the
     per-tile [start, end) ranges come from a count per tile,
  5. the slot map `slot_pos` [kmax, N] gives, for each (slot j, gaussian),
     the position of its record in the sorted record array, or -1 (the
     inverse of the sort's permutation over the j-major emission).  The
     backward gathers the per-record gradients through it and sums over
     j: a deterministic per-gaussian reduce with no scatter-add.

The JAX package's static budgets (`kmax_pack`, `class_spec`, chunk maps)
exist only to give XLA static shapes; they have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatco_torch.ops.projection import ProjectedCols

TILE = 32
# record rows
C_MX, C_MY, C_CA, C_CB, C_CC, C_OP, C_R, C_G, C_B = range(9)
NUM_REC = 9


class BinnedGaussians(NamedTuple):
    records: torch.Tensor     # [9, P] f32, tile segments front to back
    gauss_id: torch.Tensor    # [P] i64: the gaussian of each record
    tile_start: torch.Tensor  # [num_tiles] i32 segment starts
    tile_end: torch.Tensor    # [num_tiles] i32 segment ends
    num_clipped: torch.Tensor  # [] i64: gaussians whose rect was clipped
    max_slots: torch.Tensor    # [] i64: most reach-valid tiles of one
                               #   gaussian
    slot_pos: torch.Tensor     # [kmax, N] i64: record position of each
                               #   (slot, gaussian), -1 where none


def _rects(mx, my, rad, tile_size: int, tiles_x: int, tiles_y: int,
           kmax: int):
    """Per-gaussian clipped tile rects: (x0, y0, sx_c, counts, clipped)."""
    i32 = torch.int32
    r = rad
    x0 = torch.clamp(torch.floor((mx - r) / tile_size), 0, tiles_x).to(i32)
    y0 = torch.clamp(torch.floor((my - r) / tile_size), 0, tiles_y).to(i32)
    x1 = torch.clamp(torch.ceil((mx + r) / tile_size), 0, tiles_x).to(i32)
    y1 = torch.clamp(torch.ceil((my + r) / tile_size), 0, tiles_y).to(i32)
    sx = torch.clamp_min(x1 - x0, 0)
    sy = torch.clamp_min(y1 - y0, 0)
    clipped = (sx * sy > kmax) & (rad > 0)
    # saturate before the cast, as XLA's float->int conversion does
    lim = float(2 ** 30)
    cx = torch.clamp(torch.clamp(mx / tile_size, -lim, lim).to(i32),
                     0, tiles_x - 1)
    cy = torch.clamp(torch.clamp(my / tile_size, -lim, lim).to(i32),
                     0, tiles_y - 1)
    sx_c = torch.clamp_max(sx, kmax)
    sy_c = torch.minimum(sy, torch.clamp_min(kmax // torch.clamp_min(sx_c, 1),
                                             1))
    sx_c = torch.minimum(sx_c,
                         torch.clamp_min(kmax // torch.clamp_min(sy_c, 1), 1))
    sx_c = torch.where(clipped, sx_c, sx)
    sy_c = torch.where(clipped, sy_c, sy)
    x0 = torch.where(clipped,
                     torch.clamp(cx - sx_c // 2, x0,
                                 torch.maximum(x1 - sx_c, x0)), x0)
    y0 = torch.where(clipped,
                     torch.clamp(cy - sy_c // 2, y0,
                                 torch.maximum(y1 - sy_c, y0)), y0)
    counts = torch.where(rad > 0, sx_c * sy_c, 0)
    return x0, y0, sx_c, counts, clipped


def _slot_grid(mx, my, ca, cb, cc, op, x0, y0, sx_c, counts,
               tile_size: int, tiles_x: int, kmax: int, num_tiles: int):
    """[kmax, N] tile-of-slot grid (j-major enumeration of the clipped
    rect) with the exact ellipse-reach test; invalid slots get
    `num_tiles`."""
    j = torch.arange(kmax, dtype=torch.int32, device=mx.device)[:, None]
    w = torch.clamp_min(sx_c, 1)[None, :]
    ly = j // w
    lx = j % w
    txs = x0[None, :] + lx
    tys = y0[None, :] + ly

    u0 = (txs * tile_size).to(torch.float32) - mx[None, :]
    u1 = u0 + (tile_size - 1)
    v0 = (tys * tile_size).to(torch.float32) - my[None, :]
    v1 = v0 + (tile_size - 1)
    cae, cbe, cce = ca[None, :], cb[None, :], cc[None, :]
    r_vc = (-cb / torch.where(cc != 0.0, cc, 1.0))[None, :]
    r_uc = (-cb / torch.where(ca != 0.0, ca, 1.0))[None, :]

    def _edge_u(u):
        vs = torch.clamp(r_vc * u, v0, v1)
        return cae * u * u + 2.0 * cbe * u * vs + cce * vs * vs

    def _edge_v(v):
        us = torch.clamp(r_uc * v, u0, u1)
        return cae * us * us + 2.0 * cbe * us * v + cce * v * v

    inside = (u0 <= 0) & (0 <= u1) & (v0 <= 0) & (0 <= v1)
    qmin = torch.minimum(torch.minimum(_edge_u(u0), _edge_u(u1)),
                         torch.minimum(_edge_v(v0), _edge_v(v1)))
    qmin = torch.where(inside, 0.0, qmin)
    reach = (qmin * (1.0 - 1e-3)
             <= 2.0 * torch.log(255.0 * torch.clamp_min(op, 1e-12))[None, :])
    slot_valid = (j < counts[None, :]) & reach
    return torch.where(slot_valid, tys * tiles_x + txs,
                       num_tiles).to(torch.int32)


def slot_tiles(proj: ProjectedCols, opacities: torch.Tensor,
               tile_size: int, tiles_x: int, tiles_y: int, kmax: int):
    """(tile_of_slot [kmax, N] int32 with `num_tiles` for an invalid slot,
    clipped [N] bool): steps 1-2 above."""
    x0, y0, sx_c, counts, clipped = _rects(
        proj.mx, proj.my, proj.radius.to(torch.float32), tile_size,
        tiles_x, tiles_y, kmax)
    tile_of_slot = _slot_grid(proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                              opacities.to(torch.float32), x0, y0, sx_c,
                              counts, tile_size, tiles_x, kmax,
                              tiles_x * tiles_y)
    return tile_of_slot, clipped


def bin_gaussians(proj: ProjectedCols, colors: torch.Tensor,
                  opacities: torch.Tensor, tile_size: int, tiles_x: int,
                  tiles_y: int, kmax: int = 12) -> BinnedGaussians:
    """Bin projected gaussians into depth-ordered per-tile segments.
    colors [N,3], opacities [N]; gaussians with radius 0 emit nothing."""
    tile_of_slot, clipped = slot_tiles(proj, opacities, tile_size, tiles_x,
                                       tiles_y, kmax)
    return bin_slots(proj, colors, opacities, tile_of_slot, clipped,
                     tiles_x * tiles_y)


def bin_slots(proj: ProjectedCols, colors: torch.Tensor,
              opacities: torch.Tensor, tile_of_slot: torch.Tensor,
              clipped: torch.Tensor, num_tiles: int) -> BinnedGaussians:
    """Steps 3-5 above for a slot grid [kmax, N]: slot j of a gaussian is
    emitted j-major, so among gaussians at equal depth in one tile the
    lower slot rank, then the lower gaussian index, comes first."""
    n = proj.mx.shape[0]
    kmax = tile_of_slot.shape[0]
    mx, my = proj.mx, proj.my
    ca, cb, cc = proj.ca, proj.cb, proj.cc
    op = opacities.to(torch.float32)
    valid = tile_of_slot < num_tiles
    max_slots = valid.sum(dim=0).max() if n else torch.zeros(
        (), dtype=torch.int64, device=mx.device)

    # valid pairs in j-major slot order (slot = j * n + gaussian)
    slot = torch.nonzero(valid.reshape(-1)).squeeze(1)
    tile = tile_of_slot.reshape(-1)[slot].to(torch.int64)
    gid = slot % max(n, 1)
    depth_bits = proj.depth[gid].contiguous().view(torch.int32)
    key = (tile << 32) | depth_bits.to(torch.int64)
    order = torch.argsort(key, stable=True)
    gid = gid[order]
    tile = tile[order]
    slot_pos = torch.full((kmax * n,), -1, dtype=torch.int64,
                          device=mx.device)
    slot_pos[slot[order]] = torch.arange(order.shape[0], device=mx.device)

    cols = torch.stack([mx, my, ca, cb, cc, op, colors[:, 0], colors[:, 1],
                        colors[:, 2]]).to(torch.float32)
    records = cols.index_select(1, gid).contiguous()
    per_tile = torch.bincount(tile, minlength=num_tiles)
    tile_end = torch.cumsum(per_tile, 0)
    tile_start = tile_end - per_tile
    return BinnedGaussians(
        records=records, gauss_id=gid,
        tile_start=tile_start.to(torch.int32),
        tile_end=tile_end.to(torch.int32),
        num_clipped=clipped.sum(), max_slots=max_slots,
        slot_pos=slot_pos.reshape(kmax, n))
