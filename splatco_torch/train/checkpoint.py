"""Loading the JAX trainer's model checkpoints (the loading half of
splatco_tpu/train/checkpoint.py).

A saved model is `point_cloud/iteration_N/` holding the anchor PLY (the
reference schema), `checkpoints.npz` (decoder and plane arrays keyed by
`jax.tree_util.keystr` paths) and optionally `meta.json`.  Shapes come
from the archive itself, so no template model is needed.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from splatco_torch.data.ply import read_ply
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.utils.device import resolve_device


def load_anchor_ply(path: str, capacity: int = 0, pad_multiple: int = 256
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Anchor PLY -> (padded anchor arrays, active mask)."""
    v = read_ply(path)
    n = len(v["x"])
    if capacity <= 0:
        capacity = ((max(n, 1) + pad_multiple - 1)
                    // pad_multiple) * pad_multiple

    def group(prefix):
        names = sorted((k for k in v if k.startswith(prefix)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([v[k] for k in names], axis=1).astype(np.float32)

    offsets = group("f_offset_")
    k = offsets.shape[1] // 3
    offsets = offsets.reshape(n, 3, k).transpose(0, 2, 1)  # -> [N,K,3]

    def pad(a):
        out = np.zeros((capacity,) + a.shape[1:], np.float32)
        out[:n] = a
        return out

    anchors = {
        "anchor": pad(np.stack([v["x"], v["y"], v["z"]], 1
                               ).astype(np.float32)),
        "feat": pad(group("f_anchor_feat_")),
        "offsets": pad(offsets),
        "scaling": pad(group("scale_")),
        "rotation": pad(group("rot_")),
        "opacity": pad(np.asarray(v["opacity"], np.float32)[:, None]),
    }
    active = np.zeros(capacity, bool)
    active[:n] = True
    return anchors, active


def latest_iteration(model_path: str) -> Optional[int]:
    pc = os.path.join(model_path, "point_cloud")
    if not os.path.isdir(pc):
        return None
    its = [int(d.split("_")[-1]) for d in os.listdir(pc)
           if d.startswith("iteration_")]
    return max(its) if its else None


def load_model_checkpoint(model_path: str, iteration: int,
                          capacity: int = 0, device=None):
    """-> (params, active [C] bool, meta dict or None) on `device`."""
    dev = resolve_device(device)
    pc_dir = os.path.join(model_path, "point_cloud",
                          f"iteration_{iteration}")
    anchors, active = load_anchor_ply(
        os.path.join(pc_dir, "point_cloud.ply"), capacity=capacity)
    flat = {f"['anchors']['{name}']": arr for name, arr in anchors.items()}
    with np.load(os.path.join(pc_dir, "checkpoints.npz"),
                 allow_pickle=False) as archive:
        flat.update({key: archive[key] for key in archive.files})
    params = params_from_numpy(flat, device=dev)
    meta = None
    meta_path = os.path.join(pc_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    return params, torch.as_tensor(active, device=dev), meta
