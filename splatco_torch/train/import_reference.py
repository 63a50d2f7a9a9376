"""Import a reference-trained SplatCo model (the original PyTorch/CUDA
pipeline's checkpoints), the counterpart of
splatco_tpu/train/import_reference.py.

Reference artifact families:
  * anchor PLY — point_cloud/iteration_N/point_cloud.ply, read by
    train/checkpoint.py's `load_anchor_ply`;
  * decoder MLPs — point_cloud/iteration_N/checkpoints.pth, a dict of
    torch Sequential state dicts ('unite' mode);
  * tri-plane + contractor — chkpnt<N>.pth =
    (feat_planes.state_dict(), contractor.state_dict()).

The state dicts become a numpy dict in the JAX package's layout, keyed by
`jax.tree_util.keystr` paths, and `params_from_numpy` carries it to the
device.  Layout conversions:
  * nn.Linear weight [out, in] -> "w" [in, out] (transpose);
  * BatchNorm1d weight/bias -> scale/bias (running stats ignored: the
    reference's fusion BN runs in train mode even at eval);
  * PlaneGrid planes [1, R, H, W] -> [R, H, W];
  * TriPlaneAttention 1x1 convs [h, C, 1, 1] -> [C, h] matmuls, the 7x7
    spatial conv [1, 2, 7, 7] (OIHW) -> HWIO [7, 7, 2, 1];
  * k0s has num_levels + 1 entries (level 0 twice, the duplicate-level-0
    quirk): k0s.0-2 map onto grids 0-2, k0s.3 is never read.
Which decoders exist comes from the config (feature bank, appearance).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from splatco_torch.config import ModelConfig
from splatco_torch.models.decoders import init_decoders
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.models.triplane import init_feature_planes, level_sizes
from splatco_torch.train.checkpoint import load_anchor_ply, params_to_numpy
from splatco_torch.utils.device import resolve_device

Flat = Dict[str, np.ndarray]
# the reference's names of the decoder MLPs
DECODER_NAMES = {"opacity": "opacity_mlp", "cov": "cov_mlp",
                 "color": "color_mlp", "feature_bank": "feature_bank_mlp"}
NUM_LEVELS = 3


def _load_torch(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _lin(sd: Dict[str, Any], prefix: str, key: str) -> Flat:
    return {f"{key}['w']": _np(sd[prefix + "weight"]).T,
            f"{key}['b']": _np(sd[prefix + "bias"])}


def _bn(sd: Dict[str, Any], prefix: str, key: str) -> Flat:
    return {f"{key}['scale']": _np(sd[prefix + "weight"]),
            f"{key}['bias']": _np(sd[prefix + "bias"])}


def _decoder_template(cfg: ModelConfig) -> Flat:
    """The decoders the config builds, at their shapes."""
    return params_to_numpy(init_decoders(
        cfg.feat_dim, cfg.n_offsets, torch.Generator(),
        appearance_dim=cfg.appearance_dim, use_feat_bank=cfg.use_feat_bank,
        add_opacity_dist=cfg.add_opacity_dist,
        add_cov_dist=cfg.add_cov_dist, add_color_dist=cfg.add_color_dist),
        "['decoders']")


def import_decoders(ckpt: Dict[str, Any], cfg: ModelConfig) -> Flat:
    """checkpoints.pth ('unite') -> the decoder arrays.  Sequential
    indices: Linear at 0 and 2 (the activations carry no params)."""
    want = _decoder_template(cfg)
    out: Flat = {}
    for ours, theirs in DECODER_NAMES.items():
        if f"['decoders']['{ours}'][0]['w']" not in want:
            continue
        if theirs not in ckpt:
            raise KeyError(
                f"reference checkpoints.pth lacks '{theirs}' but the model "
                f"config requires it (keys: {sorted(ckpt)})")
        for layer, prefix in enumerate(("0.", "2.")):
            out.update(_lin(ckpt[theirs], prefix,
                            f"['decoders']['{ours}'][{layer}]"))
    for key, arr in out.items():
        if arr.shape != want[key].shape:
            raise ValueError(f"{key}: reference weight {arr.shape} vs model "
                             f"{want[key].shape}: feat_dim/n_offsets "
                             "mismatch?")
    if cfg.appearance_dim > 0:
        out["['decoders']['appearance']['table']"] = _np(
            ckpt["appearance"]["embedding.weight"])
    return out


def import_feat_planes(fp_state: Dict[str, Any], cfg: ModelConfig) -> Flat:
    """feat_planes.state_dict() (GaussianLearner, '_feat.' prefix) -> the
    plane arrays: grids, heads, ctx_heads, tpa."""
    p = "_feat."
    sizes = level_sizes(cfg.plane_size, NUM_LEVELS,
                        cfg.quirk_duplicate_level0)
    r = cfg.num_channels // 3
    out: Flat = {}
    for i in range(NUM_LEVELS):
        for plane in ("xy", "xz", "yz"):
            arr = _np(fp_state[f"{p}k0s.{i}.{plane}_plane"])[0]  # drop N=1
            if arr.shape != (r, sizes[i], sizes[i]):
                raise ValueError(
                    f"k0s.{i}.{plane}_plane {arr.shape} vs model "
                    f"{(r, sizes[i], sizes[i])}: plane_size/num_channels or "
                    "duplicate-level-0 quirk mismatch?")
            out[f"['planes']['grids'][{i}]['{plane}']"] = arr
        for theirs, ours in (("models", "heads"), ("CTX_models", "ctx_heads")):
            key = f"['planes']['{ours}'][{i}]"
            out.update(_bn(fp_state, f"{p}{theirs}.{i}.0.", key + "['bn']"))
            out.update(_lin(fp_state, f"{p}{theirs}.{i}.1.", key + "['lin']"))
    ta = f"{p}k0s.0.TA."
    out["['planes']['tpa']['ca_w1']"] = _np(
        fp_state[ta + "ca.sharedMLP.0.weight"])[:, :, 0, 0].T
    out["['planes']['tpa']['ca_w2']"] = _np(
        fp_state[ta + "ca.sharedMLP.2.weight"])[:, :, 0, 0].T
    out["['planes']['tpa']['sa_w']"] = _np(
        fp_state[ta + "sa.conv.weight"]).transpose(2, 3, 1, 0)
    return out


def import_contractor(ct_state: Dict[str, Any]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    return _np(ct_state["xyz_min"]), _np(ct_state["xyz_max"])


def load_reference_model(model_path: str, iteration: int, cfg: ModelConfig,
                         capacity: int = 0, device=None
                         ) -> Tuple[Dict[str, Any], torch.Tensor,
                                    Optional[Tuple[np.ndarray, np.ndarray]]]:
    """A reference-format model directory -> (params, active,
    contractor_bounds) on `device` (None: the card): anchor PLY +
    checkpoints.pth + chkpnt<N>.pth.  Without a chkpnt file (a PLY-only
    export) the planes are the config's random init (seed 0) and the
    bounds None."""
    dev = resolve_device(device)
    pc_dir = os.path.join(model_path, "point_cloud",
                          f"iteration_{iteration}")
    anchors, active = load_anchor_ply(
        os.path.join(pc_dir, "point_cloud.ply"), capacity=capacity)
    flat = {f"['anchors']['{name}']": arr for name, arr in anchors.items()}
    flat.update(import_decoders(
        _load_torch(os.path.join(pc_dir, "checkpoints.pth")), cfg))
    bounds = None
    chk = os.path.join(model_path, f"chkpnt{iteration}.pth")
    if os.path.exists(chk):
        fp_state, ct_state = _load_torch(chk)
        flat.update(import_feat_planes(fp_state, cfg))
        bounds = import_contractor(ct_state)
    else:
        ctx_dim = cfg.feat_dim + 3 + 3 * cfg.n_offsets + 6
        flat.update(params_to_numpy(init_feature_planes(
            cfg.plane_size, cfg.num_channels,
            torch.Generator().manual_seed(0), ctx_dim=ctx_dim,
            quirk_duplicate_level0=cfg.quirk_duplicate_level0),
            "['planes']"))
    return (params_from_numpy(flat, device=dev),
            torch.as_tensor(active, device=dev), bounds)
