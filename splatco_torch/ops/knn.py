"""Spatial stats for anchor initialization (counterpart of
splatco_tpu/ops/knn.py).

`mean_knn_sq_dist`: mean SQUARED distance to the 3 nearest neighbours,
searched exactly within a +-`window` rank window of the Morton ordering
(one stable argsort of the Morton code, as `jnp.argsort` is stable).
`voxelize`: snap to the voxel grid and keep one point per occupied voxel
(numpy, identical to the JAX package's).
"""
from __future__ import annotations

import numpy as np
import torch


def _morton_bits(q: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits of each of 3 coords into a 30-bit Morton code.
    q: [N,3] int32 in [0, 1024)."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, window: int = 64
                     ) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbours,
    searched within a +-window rank window of the Morton ordering."""
    n = points.shape[0]
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    q = ((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0
         ).to(torch.int32)
    order = torch.argsort(_morton_bits(q), stable=True)
    sorted_pts = points[order]

    idx = torch.arange(n, device=points.device)
    offs = torch.cat([torch.arange(-window, 0, device=points.device),
                      torch.arange(1, window + 1, device=points.device)])
    nbr = torch.clamp(idx[:, None] + offs[None, :], 0, n - 1)   # [N, 2w]
    diffs = sorted_pts[nbr] - sorted_pts[:, None, :]            # [N, 2w, 3]
    d2 = torch.sum(diffs * diffs, dim=-1)
    d2 = torch.where(nbr == idx[:, None], torch.inf, d2)
    top = torch.topk(d2, k, dim=-1, largest=False).values       # ascending
    top = torch.where(torch.isfinite(top), top, 0.0)
    mean_sorted = top.mean(dim=-1)
    out = torch.empty_like(mean_sorted)
    out[order] = mean_sorted
    return out


def voxelize(points: np.ndarray, voxel_size: float, seed: int = 0
             ) -> np.ndarray:
    """Shuffle, snap to the voxel grid, unique (one representative per
    occupied voxel)."""
    pts = np.array(points, dtype=np.float64)
    rng = np.random.default_rng(seed)
    rng.shuffle(pts)
    snapped = np.unique(np.round(pts / voxel_size), axis=0) * voxel_size
    return snapped.astype(np.float32)
