"""Anchor state (counterpart of splatco_tpu/models/anchors.py).

A fixed-capacity padded set of anchors with an `active` mask, exactly as
the JAX package lays it out, so checkpoints and parameter dicts carry over
row for row.  Per-anchor fields: anchor [C,3], feat [C,F], offsets [C,K,3],
scaling [C,6] (log-scales), rotation [C,4], opacity [C,1].
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from splatco_torch.ops.knn import mean_knn_sq_dist, voxelize
from splatco_torch.utils.math import inverse_sigmoid, round_up


def init_anchor_state(
    points: np.ndarray,
    feat_dim: int,
    n_offsets: int,
    voxel_size: float,
    capacity: int = 0,
    ratio: int = 1,
    pad_multiple: int = 256,
    device: torch.device = torch.device("cpu"),
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, float]:
    """create_from_pcd equivalent.  Returns (anchors, active, voxel_size);
    the 3-NN statistics run on `device`."""
    pts = np.asarray(points, np.float32)[::ratio]
    if voxel_size <= 0:
        d2 = mean_knn_sq_dist(torch.as_tensor(pts, device=device))
        voxel_size = float(np.median(d2.cpu().numpy()))
    vox = voxelize(pts, voxel_size)
    n = vox.shape[0]
    if capacity <= 0:
        capacity = round_up(max(4 * n, 2 * pad_multiple), pad_multiple)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} anchors")

    d2 = mean_knn_sq_dist(torch.as_tensor(vox, device=device))
    log_scales = torch.log(torch.sqrt(torch.clamp_min(d2, 1e-7)))
    log_scales = log_scales[:, None].expand(n, 6)

    def pad(a: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((capacity,) + tuple(a.shape[1:]),
                          dtype=torch.float32, device=device)
        out[:n] = a
        return out

    rots = torch.zeros((n, 4), device=device)
    rots[:, 0] = 1.0
    opac = inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32))
    active = torch.zeros((capacity,), dtype=torch.bool, device=device)
    active[:n] = True
    anchors = {
        "anchor": pad(torch.as_tensor(vox, device=device)),
        "feat": pad(torch.zeros((n, feat_dim), device=device)),
        "offsets": pad(torch.zeros((n, n_offsets, 3), device=device)),
        "scaling": pad(log_scales),
        "rotation": pad(rots),
        "opacity": pad(torch.full((n, 1), float(opac), device=device)),
    }
    return anchors, active, voxel_size
