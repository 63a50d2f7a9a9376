"""Model and training checkpoints (counterpart of
splatco_tpu/train/checkpoint.py), written and read in the JAX package's
formats, so either package reads what the other wrote.

A saved model is `point_cloud/iteration_N/` holding the anchor PLY (the
reference schema), `checkpoints.npz` (decoder and plane arrays keyed by
`jax.tree_util.keystr` paths) and optionally `meta.json`.  A training
state is `chkpnt<N>.npz` (any nested dict/list of tensors, keyed the same
way) beside `chkpnt<N>.json` (the trainer's scalars).  Shapes come from
the archives themselves, so no template model is needed to load one.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from splatco_torch.data.ply import read_ply, write_ply
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.utils.device import resolve_device


def save_anchor_ply(path: str, anchors: Dict[str, torch.Tensor],
                    active: torch.Tensor) -> None:
    """The active anchors in the reference's PLY schema: xyz, zero
    normals, f_offset_* ([N,K,3] -> [N,3,K] flattened), f_anchor_feat_*,
    opacity, scale_*, rot_*."""
    sel = torch.nonzero(active.cpu()).flatten()

    def rows(name):
        return anchors[name].detach().cpu()[sel].numpy().astype(np.float32)

    anchor, feat, opacity = rows("anchor"), rows("feat"), rows("opacity")
    scaling, rotation = rows("scaling"), rows("rotation")
    n = len(sel)
    offsets = rows("offsets").transpose(0, 2, 1).reshape(n, -1)
    cols = {name: anchor[:, i] for i, name in enumerate("xyz")}
    cols.update({name: np.zeros(n, np.float32) for name in ("nx", "ny",
                                                           "nz")})
    cols.update({f"f_offset_{i}": offsets[:, i]
                 for i in range(offsets.shape[1])})
    cols.update({f"f_anchor_feat_{i}": feat[:, i]
                 for i in range(feat.shape[1])})
    cols["opacity"] = opacity[:, 0]
    cols.update({f"scale_{i}": scaling[:, i]
                 for i in range(scaling.shape[1])})
    cols.update({f"rot_{i}": rotation[:, i]
                 for i in range(rotation.shape[1])})
    write_ply(path, cols)


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


def params_to_numpy(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{keystr path: array} of a nested dict/list of tensors: the inverse
    of `params_from_numpy`, and the key format of the JAX archives."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach().cpu().numpy()}
    out = {}
    for key, val in items:
        out.update(params_to_numpy(val, prefix + key))
    return out


def save_pytree(path: str, tree) -> None:
    """An .npz archive of the tree's arrays, stored without compression:
    trained float32 weights deflate by ~7% at ~16 MB/s, which would make
    a full-width training state take ~40 s to write.  np.load reads
    stored and deflated archives alike, so both packages read it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **params_to_numpy(tree))


def _read_archive(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as archive:
        return {key: archive[key] for key in archive.files}


def load_pytree(path: str, device=None):
    """The nested tree of an archive `save_pytree` (or the JAX package's)
    wrote, on `device`."""
    return params_from_numpy(_read_archive(path), device=device)


def load_pytree_like(path: str, template):
    """An archive loaded into the structure of `template` (a nested
    dict/list of tensors): every leaf of the template must be there with
    its shape, and takes its dtype and device."""
    archive = _read_archive(path)

    def build(tree, key):
        if isinstance(tree, dict):
            return {k: build(v, f"{key}['{k}']") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, f"{key}[{i}]")
                              for i, v in enumerate(tree))
        if key not in archive:
            raise KeyError(f"{path} has no {key}")
        if archive[key].shape != tuple(tree.shape):
            raise ValueError(f"{key}: {archive[key].shape} in {path}, "
                             f"{tuple(tree.shape)} in the template")
        return torch.as_tensor(archive[key], dtype=tree.dtype,
                               device=tree.device)

    return build(template, "")


def save_model_checkpoint(model_path: str, iteration: int,
                          params: Dict[str, Any], active: torch.Tensor,
                          meta: Optional[dict] = None) -> None:
    """point_cloud/iteration_N/{point_cloud.ply, checkpoints.npz,
    meta.json}."""
    pc_dir = os.path.join(model_path, "point_cloud",
                          f"iteration_{iteration}")
    os.makedirs(pc_dir, exist_ok=True)
    save_anchor_ply(os.path.join(pc_dir, "point_cloud.ply"),
                    params["anchors"], active)
    save_pytree(os.path.join(pc_dir, "checkpoints.npz"),
                {"decoders": params["decoders"], "planes": params["planes"]})
    if meta is not None:
        with open(os.path.join(pc_dir, "meta.json"), "w") as fh:
            json.dump(meta, fh)


def save_train_state(model_path: str, iteration: int, tree,
                     meta: dict) -> None:
    """The whole training state: `tree` (params, optimizer state, densify
    statistics, active mask...) to chkpnt<N>.npz, `meta` (the trainer's
    scalars) to chkpnt<N>.json."""
    base = os.path.join(model_path, f"chkpnt{iteration}")
    save_pytree(base + ".npz", tree)
    with open(base + ".json", "w") as fh:
        json.dump(meta, fh)


def load_train_state(model_path: str, iteration: int, device=None):
    """-> (tree on `device`, meta) of `save_train_state`."""
    dev = resolve_device(device)
    base = os.path.join(model_path, f"chkpnt{iteration}")
    tree = load_pytree(base + ".npz", device=dev)
    with open(base + ".json") as fh:
        meta = json.load(fh)
    return tree, meta


def latest_train_checkpoint(model_path: str) -> Optional[int]:
    its = []
    if not os.path.isdir(model_path):
        return None
    for name in os.listdir(model_path):
        if name.startswith("chkpnt") and name.endswith(".json"):
            try:
                its.append(int(name[len("chkpnt"):-len(".json")]))
            except ValueError:
                pass
    return max(its) if its else None


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
    flat.update(_read_archive(os.path.join(pc_dir, "checkpoints.npz")))
    params = params_from_numpy(flat, device=dev)
    meta = None
    meta_path = os.path.join(pc_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    return params, torch.as_tensor(active, device=dev), meta
