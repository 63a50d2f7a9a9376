"""Spatial context grids (counterpart of splatco_tpu/models/context_grid.py):
the `use_spatial_ctx` local branch.

  * `grid_create`: per-cell masked mean of point features, scattered into
    a dense grid of resolution**d cells (the reference's grid_creater);
  * `grid_encode`: d-linear interpolation out of one grid (grid_encoder);
  * `spatial_ctx`: one level's 3-D grid and its xy/xz/yz projections,
    scatter then interpolate, concatenated -> [N, 4F].

Resolutions: 2-D (300, 400, 500), 3-D (60, 80, 100) per level.  The
scatter is `index_put(accumulate=True)`, which PyTorch runs on the card
as a sort and an ordered segmented sum: deterministic, with no float
atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

RESOLUTIONS_2D = (300, 400, 500)
RESOLUTIONS_3D = (60, 80, 100)


def normalize_xyz(xyz: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Coords in [lo, hi]^d into [0, 1]^d."""
    return (xyz - lo) / max(hi - lo, 1e-9)


def _flat_index(q: torch.Tensor, resolution: int) -> torch.Tensor:
    idx = q[..., 0]
    for a in range(1, q.shape[-1]):
        idx = idx * resolution + q[..., a]
    return idx


def _cell_ids(xyz01: torch.Tensor, resolution: int) -> torch.Tensor:
    """Nearest-cell index per point for one level; xyz01 in [0,1]^d."""
    q = torch.clamp((xyz01 * resolution).to(torch.int64), 0, resolution - 1)
    return _flat_index(q, resolution)


def grid_create(xyz01: torch.Tensor, features: torch.Tensor,
                resolution: int, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Per-cell masked mean of point features -> [resolution**d, F]."""
    n_cells = resolution ** xyz01.shape[-1]
    ids = _cell_ids(xyz01, resolution)
    w = torch.ones(xyz01.shape[0], dtype=features.dtype,
                   device=features.device)
    if mask is not None:
        w = w * mask.to(features.dtype)
    sums = features.new_zeros((n_cells, features.shape[1])).index_put(
        (ids,), features * w[:, None], accumulate=True)
    counts = features.new_zeros(n_cells).index_put((ids,), w,
                                                   accumulate=True)
    return sums / (counts[:, None] + 1e-9)


def grid_encode(xyz01: torch.Tensor, table: torch.Tensor, resolution: int
                ) -> torch.Tensor:
    """d-linear interpolation out of one level's table:
    xyz01 [N,d], table [resolution**d, F] -> [N, F]."""
    d = xyz01.shape[-1]
    pos = torch.clamp(xyz01, 0.0, 1.0) * (resolution - 1)
    p0 = torch.floor(pos)
    frac = pos - p0
    p0 = p0.to(torch.int64)
    out = 0.0
    for corner in range(2 ** d):
        offs = [(corner >> a) & 1 for a in range(d)]
        q = torch.stack([torch.clamp(p0[:, a] + offs[a], 0, resolution - 1)
                         for a in range(d)], dim=-1)
        wgt = torch.ones(xyz01.shape[0], dtype=table.dtype,
                         device=table.device)
        for a in range(d):
            wgt = wgt * (frac[:, a] if offs[a] == 1 else 1.0 - frac[:, a])
        out = out + table[_flat_index(q, resolution)] * wgt[:, None]
    return out


def spatial_ctx(xyz: torch.Tensor, features: torch.Tensor, lo: float,
                hi: float, level: int = 0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One level of Spatial_CTX: the 3-D grid and the xy/xz/yz grids,
    scatter then interpolate, concatenated -> [N, 4F]."""
    xyz01 = normalize_xyz(xyz, lo, hi)
    r3 = RESOLUTIONS_3D[level]
    r2 = RESOLUTIONS_2D[level]
    planes = [xyz01, xyz01[:, 0:2], xyz01[:, 0::2], xyz01[:, 1:3]]
    outs = []
    for coords, reso in zip(planes, (r3, r2, r2, r2)):
        table = grid_create(coords, features, reso, mask=mask)
        outs.append(grid_encode(coords, table, reso))
    return torch.cat(outs, dim=-1)
