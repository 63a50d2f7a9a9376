"""SplatCo model assembly: anchors + CSCM tri-planes + decoders +
contractor (counterpart of splatco_tpu/models/splatco.py).

Parameters are a nested dict of tensors with the JAX package's tree
layout, so a parameter is named by the same path in both packages:
`params["decoders"]["color"][0]["w"]` here is the leaf that
`jax.tree_util.keystr` names "['decoders']['color'][0]['w']" there.
`params_from_numpy` rebuilds the tree from such flat keys — the format of
the JAX checkpoint archives.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from splatco_torch.config import ModelConfig
from splatco_torch.models.anchors import init_anchor_state
from splatco_torch.models.contraction import Contractor, make_contractor
from splatco_torch.models.decoders import init_decoders
from splatco_torch.models.triplane import init_feature_planes
from splatco_torch.utils.device import resolve_device


@dataclasses.dataclass
class ModelState:
    """Non-trainable runtime state carried alongside the params."""
    active: torch.Tensor       # [C] anchor liveness
    contractor: Contractor
    voxel_size: float


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def init_model(cfg: ModelConfig, points: np.ndarray, *,
               generator: torch.Generator, num_cameras: int = 0,
               device=None) -> Tuple[Dict[str, Any], ModelState]:
    """Random-init the model from a point cloud.  Draws come from
    `generator` on the CPU, so a seed gives the same model on any device."""
    dev = resolve_device(device)
    if cfg.use_spatial_ctx:
        raise NotImplementedError(
            "use_spatial_ctx (models/context_grid.py) is not ported yet; "
            "see ROADMAP.md, 'Modules to port'")
    anchors, active, voxel_size = init_anchor_state(
        points, cfg.feat_dim, cfg.n_offsets, cfg.voxel_size,
        capacity=cfg.capacity, ratio=cfg.ratio, device=dev)
    ctx_dim = cfg.feat_dim + 3 + 3 * cfg.n_offsets + 6
    decoders = init_decoders(
        cfg.feat_dim, cfg.n_offsets, generator,
        appearance_dim=cfg.appearance_dim,
        use_feat_bank=cfg.use_feat_bank,
        add_opacity_dist=cfg.add_opacity_dist,
        add_cov_dist=cfg.add_cov_dist,
        add_color_dist=cfg.add_color_dist,
        num_cameras=num_cameras)
    planes = init_feature_planes(
        cfg.plane_size, cfg.num_channels, generator, ctx_dim=ctx_dim,
        quirk_duplicate_level0=cfg.quirk_duplicate_level0)
    params = {"anchors": anchors,
              "decoders": _tree_to(decoders, dev),
              "planes": _tree_to(planes, dev)}
    state = ModelState(
        active=active,
        contractor=make_contractor(cfg.scene_center, cfg.scene_length,
                                   cfg.bbox_scale, enabled=cfg.contractor,
                                   device=dev),
        voxel_size=voxel_size)
    return params, state


_KEY_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse_keystr(key: str):
    toks, pos = [], 0
    for m in _KEY_TOKEN.finditer(key):
        if m.start() != pos:
            break
        toks.append(m.group(1) if m.group(1) is not None
                    else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not toks:
        raise ValueError(f"not a keystr path: {key!r}")
    return toks


def _lists_from_int_keys(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sparse list indices {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def params_from_numpy(flat: Mapping[str, np.ndarray], device=None):
    """Nested params from arrays keyed by `jax.tree_util.keystr` paths,
    e.g. "['decoders']['color'][0]['w']" — the key format of the JAX
    checkpoint archives.  Floating arrays become float32 tensors on
    `device`; other arrays keep their dtype."""
    dev = resolve_device(device)
    root: Dict[Any, Any] = {}
    for key, arr in flat.items():
        toks = _parse_keystr(key)
        node = root
        for t in toks[:-1]:
            node = node.setdefault(t, {})
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        node[toks[-1]] = torch.as_tensor(np.ascontiguousarray(arr),
                                         device=dev)
    return _lists_from_int_keys(root)


def decode_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(
        add_opacity_dist=cfg.add_opacity_dist,
        add_cov_dist=cfg.add_cov_dist,
        add_color_dist=cfg.add_color_dist,
        appearance_dim=cfg.appearance_dim,
        use_feat_bank=cfg.use_feat_bank,
        compat_raw_domain=cfg.compat_raw_domain,
        use_spatial_ctx=cfg.use_spatial_ctx,
    )
