"""LPIPS with the VGG16 backbone (counterpart of splatco_tpu/ops/lpips.py).

VGG16 relu1_2..relu5_3 features, unit-normalised per channel, weighted by
the 1x1 "lin" weights, averaged over space and summed over the stages,
as the reference's lpipsPyTorch computes it.

No weights ship with the repository and none are downloaded: they come
as an .npz (keys conv{i}_w [out,in,3,3], conv{i}_b, lin{s} [C]; written
by tools/export_lpips_weights.py), by path or through
SPLATCO_LPIPS_WEIGHTS.  Without them `load_weights` returns None and the
metrics driver records lpips = null.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splatco_torch.utils.device import resolve_device

# VGG16 conv plan: (out_channels, layers per block); LPIPS reads the relu
# of each block's last conv: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
STAGE_CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

WEIGHTS_ENV = "SPLATCO_LPIPS_WEIGHTS"


def load_weights(path: Optional[str] = None,
                 device=None) -> Optional[Dict[str, torch.Tensor]]:
    """The .npz at `path` (else $SPLATCO_LPIPS_WEIGHTS) as float32 tensors
    on `device` (None: the card), or None when there is no such file."""
    dev = resolve_device(device)
    path = path or os.environ.get(WEIGHTS_ENV, "")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for k, v in data.items()}


def random_weights(seed: int) -> Dict[str, np.ndarray]:
    """Weights in the .npz layout at VGG16's widths, drawn from a seeded
    numpy generator (He-scaled convs, small biases, lin in [0, 1)): a
    stand-in for tests and smoke runs, not a perceptual metric."""
    rng = np.random.default_rng(seed)
    out, li, cin = {}, 0, 3
    for stage, (ch, n_layers) in enumerate(VGG_PLAN):
        for _ in range(n_layers):
            out[f"conv{li}_w"] = (rng.normal(size=(ch, cin, 3, 3))
                                  * np.sqrt(2.0 / (9 * cin))).astype(
                                      np.float32)
            out[f"conv{li}_b"] = (rng.normal(size=ch) * 0.01).astype(
                np.float32)
            cin, li = ch, li + 1
        out[f"lin{stage}"] = rng.uniform(size=ch).astype(np.float32)
    return out


def _vgg_features(weights: Dict[str, torch.Tensor], x: torch.Tensor):
    """x: [3,H,W] normalised; returns the 5 stage activations [C,h,w]."""
    feats = []
    h = x[None]
    li = 0
    for stage, (_, n_layers) in enumerate(VGG_PLAN):
        for _ in range(n_layers):
            h = F.relu(F.conv2d(h, weights[f"conv{li}_w"],
                                weights[f"conv{li}_b"], padding=1))
            li += 1
        feats.append(h[0])
        if stage < len(VGG_PLAN) - 1:
            h = F.max_pool2d(h, 2)
    return feats


def lpips(weights: Dict[str, torch.Tensor], img1: torch.Tensor,
          img2: torch.Tensor, rescale: bool = False) -> torch.Tensor:
    """LPIPS distance between two [3,H,W] images in [0,1].

    rescale=False is the reference harness as shipped: lpipsPyTorch
    z-scores the raw input and its metrics.py feeds [0,1] images straight
    in, with no [-1,1] rescale.  rescale=True applies x*2-1 first (the
    convention the LPIPS weights were trained with)."""
    def norm_input(x):
        if rescale:
            x = x * 2.0 - 1.0
        return ((x - torch.as_tensor(_SHIFT, device=x.device)[:, None, None])
                / torch.as_tensor(_SCALE, device=x.device)[:, None, None])

    f1 = _vgg_features(weights, norm_input(img1))
    f2 = _vgg_features(weights, norm_input(img2))
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        a = a / torch.clamp_min(torch.linalg.vector_norm(
            a, dim=0, keepdim=True), 1e-10)
        b = b / torch.clamp_min(torch.linalg.vector_norm(
            b, dim=0, keepdim=True), 1e-10)
        d = (a - b) ** 2
        total = total + (d * weights[f"lin{i}"][:, None, None]).sum(
            dim=0).mean()
    return total
