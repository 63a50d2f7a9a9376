"""CSCM tri-plane pyramid + fusion heads (counterpart of
splatco_tpu/models/triplane.py).

  * level i feature: bilinear sample of the 3 planes (align_corners, zeros
    outside, u on the H axis) at the contracted anchor coordinates, plus
    U(-1/2, 1/2) * q quantization noise in training (q = 0 at eval),
  * level 0 additionally samples the TriPlaneAttention-modulated planes,
    interleaved per plane as [xy, xyTA, xz, xzTA, yz, yzTA],
  * geo_fea = sum over active levels of concat(BN+Linear(plane_feat),
    BN+Linear(anchor_ctx)), BN being masked train-mode BN (models/mlp.py),
  * TV regulariser: smooth-L1 of adjacent texel differences, mean of the
    6 axis terms, level-weighted 0.5^(2-level).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from splatco_torch.models.mlp import (init_batchnorm, init_linear, linear,
                                      masked_batchnorm)

CTX_DIM_BASE = 71  # feat32 + anchor3 + offsets30 + scaling6 (n_offsets=10)


def _sample_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """Bilinear sample plane [R, H, W] at normalized coords u (H axis),
    v (W axis) in [-1, 1]; align_corners=True, zeros outside.  [N] -> [N,R].
    The four corners are gathered and weighted explicitly."""
    r, h, w = plane.shape
    x = (u + 1.0) * 0.5 * (h - 1)
    y = (v + 1.0) * 0.5 * (w - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    flat = plane.reshape(r, h * w)

    def corner(cx, cy, wgt):
        inb = (cx >= 0) & (cx <= h - 1) & (cy >= 0) & (cy <= w - 1)
        idx = (torch.clamp(cx, 0, h - 1).to(torch.int64) * w
               + torch.clamp(cy, 0, w - 1).to(torch.int64))
        return flat[:, idx] * (wgt * inb.to(plane.dtype))[None, :]

    out = (corner(x0, y0, (1 - tx) * (1 - ty))
           + corner(x0 + 1, y0, tx * (1 - ty))
           + corner(x0, y0 + 1, (1 - tx) * ty)
           + corner(x0 + 1, y0 + 1, tx * ty))
    return out.T


def init_plane_grid(channels: int, size: int, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
    """Three learnable planes; R = channels // 3 each."""
    r = channels // 3
    return {name: torch.randn((r, size, size), generator=generator) * 0.1
            for name in ("xy", "xz", "yz")}


def _split_coords(xyz_norm: torch.Tensor):
    ind = xyz_norm / 2.0  # (x - (-2)) / 4 * 2 - 1
    return ind[:, 0], ind[:, 1], ind[:, 2]


def sample_plane_grid(params, xyz_norm: torch.Tensor) -> List[torch.Tensor]:
    """Query the 3 planes at xyz in the [-2,2] domain.
    Returns [xy, xz, yz] features, each [N, R]."""
    fx, fy, fz = _split_coords(xyz_norm)
    return [
        _sample_plane(params["xy"], fx, fy),
        _sample_plane(params["xz"], fx, fz),
        _sample_plane(params["yz"], fy, fz),
    ]


# ----------------------------------------------------------------------
# TriPlaneAttention (CBAM-style)
# ----------------------------------------------------------------------

def init_tpa(channels: int, generator: torch.Generator, ratio: int = 5
             ) -> Dict[str, torch.Tensor]:
    hidden = channels // ratio

    def u(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {
        # 1x1 convs as linear maps over channels (no bias)
        "ca_w1": u((channels, hidden), 1.0 / math.sqrt(channels)),
        "ca_w2": u((hidden, channels), 1.0 / math.sqrt(hidden)),
        # 7x7 conv, 2->1 channels, no bias; HWIO [7,7,2,1] as in the JAX
        # package, so weights carry over unchanged
        "sa_w": u((7, 7, 2, 1), 1.0 / math.sqrt(2 * 49)),
    }


def apply_tpa(params, x: torch.Tensor) -> torch.Tensor:
    """x: [C, H, W] (the 3 planes concatenated on channels)."""
    avg = x.mean(dim=(1, 2))
    mx = x.amax(dim=(1, 2))

    def shared(v):
        return torch.relu(v @ params["ca_w1"]) @ params["ca_w2"]

    ca = torch.sigmoid(shared(avg) + shared(mx))
    x = x * ca[:, None, None]
    # spatial attention: 7x7 "SAME" cross-correlation of [mean, max] over
    # channels; HWIO [7,7,2,1] -> OIHW [1,2,7,7]
    sa_in = torch.stack([x.mean(dim=0), x.amax(dim=0)], dim=0)[None]
    weight = params["sa_w"].permute(3, 2, 0, 1).contiguous()
    sa = F.conv2d(sa_in, weight, padding=3)
    return x * torch.sigmoid(sa[0, 0])[None]


# ----------------------------------------------------------------------
# FeaturePlanes pyramid (CSCM)
# ----------------------------------------------------------------------

def level_sizes(plane_size: int, num_levels: int = 3,
                quirk_duplicate_level0: bool = True) -> List[int]:
    sizes = [int(plane_size * 0.5 ** (num_levels - 1 - i))
             for i in range(num_levels)]
    if quirk_duplicate_level0:
        # effective reference pyramid: [ws0 (TA), ws0, ws1]
        return [sizes[0], sizes[0], sizes[1]]
    return sizes


def init_feature_planes(plane_size: int, num_channels: int,
                        generator: torch.Generator, out_dim: int = 32,
                        num_levels: int = 3, ctx_dim: int = CTX_DIM_BASE,
                        quirk_duplicate_level0: bool = True
                        ) -> Dict[str, Any]:
    sizes = level_sizes(plane_size, num_levels, quirk_duplicate_level0)
    r3 = (num_channels // 3) * 3  # actual sampled channel count
    grids, heads, ctx_heads = [], [], []
    for i in range(num_levels):
        grids.append(init_plane_grid(num_channels, sizes[i], generator))
        in_dim = r3 * 2 if i == 0 else r3  # level 0 doubled by TA
        head = {"bn": init_batchnorm(in_dim),
                "lin": init_linear(in_dim, out_dim, generator)}
        ctx = {"bn": init_batchnorm(ctx_dim),
               "lin": init_linear(ctx_dim, out_dim, generator)}
        if i > 0:
            # zero-init the fusion output layers of the not-yet-active
            # levels, so raising `activate_level` leaves geo_fea unchanged
            for h in (head, ctx):
                h["lin"] = {k: torch.zeros_like(v)
                            for k, v in h["lin"].items()}
        heads.append(head)
        ctx_heads.append(ctx)
    return {"grids": grids, "heads": heads, "ctx_heads": ctx_heads,
            "tpa": init_tpa(r3, generator)}


def sample_level_feats(params, xyz_norm: torch.Tensor,
                       activate_level: int = 0):
    """View-independent plane sampling for all active levels: one entry
    per level, (feats, ta_feats) for level 0 and (feats, None) above."""
    out = []
    for i in range(activate_level + 1):
        feats = sample_plane_grid(params["grids"][i], xyz_norm)
        ta_feats = None
        if i == 0:
            planes = params["grids"][0]
            stacked = torch.cat([planes["xy"], planes["xz"], planes["yz"]],
                                dim=0)
            att = apply_tpa(params["tpa"], stacked)
            r = planes["xy"].shape[0]
            fx, fy, fz = _split_coords(xyz_norm)
            ta_feats = [
                _sample_plane(att[:r], fx, fy),
                _sample_plane(att[r:2 * r], fx, fz),
                _sample_plane(att[2 * r:], fy, fz),
            ]
        out.append((feats, ta_feats))
    return tuple(out)


def quantization_noise(feats: List[torch.Tensor], q: float,
                       generator: torch.Generator) -> List[torch.Tensor]:
    """feats + U(-1/2, 1/2) * q, drawn from `generator` (on the features'
    device).  The draws cannot repeat `jax.random`'s, so the port and the
    JAX package add different noise of the same distribution."""
    return [f + (torch.rand(f.shape, generator=generator, device=f.device,
                            dtype=f.dtype) - 0.5) * q for f in feats]


def feature_planes_forward(params, xyz_norm: torch.Tensor,
                           g_fea: torch.Tensor, mask: torch.Tensor,
                           activate_level: int = 0, plane_feats=None,
                           q: float = 0.0,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """geo_fea [N, 2*out_dim] = hierarchical compensation sum.

    xyz_norm: [N,3] contracted coords in (-2,2); g_fea: [N,D] anchor
    context shared by all levels; mask: [N] valid rows (BN statistics);
    plane_feats: optional precomputed `sample_level_feats` output.  With
    q > 0 and a `generator`, quantization noise is added to the sampled
    features of every level and to level 0's TPA features (fresh draws on
    every call, so each view of a training step gets its own)."""
    if plane_feats is None:
        plane_feats = sample_level_feats(params, xyz_norm, activate_level)
    noisy = q > 0.0 and generator is not None
    total = None
    for i in range(activate_level + 1):
        feats, ta_feats = plane_feats[i]
        if noisy:
            feats = quantization_noise(feats, q, generator)
            if i == 0:
                ta_feats = quantization_noise(ta_feats, q, generator)
        if i == 0:
            feat = torch.cat([feats[0], ta_feats[0], feats[1], ta_feats[1],
                              feats[2], ta_feats[2]], dim=-1)
        else:
            feat = torch.cat(feats, dim=-1)
        head = params["heads"][i]
        rr = linear(head["lin"], masked_batchnorm(head["bn"], feat, mask))
        ctx = params["ctx_heads"][i]
        rrr = linear(ctx["lin"], masked_batchnorm(ctx["bn"], g_fea, mask))
        res = torch.cat([rr, rrr], dim=-1)
        total = res if total is None else total + res
    return total


def smooth_l1_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum()


def tv_loss(params, w: float, activate_level: int = 0) -> torch.Tensor:
    """Total-variation regulariser over the active plane levels."""
    total = 0.0
    for lvl in range(activate_level + 1):
        wl = w * (0.5 ** (2 - lvl))
        g = params["grids"][lvl]
        lv = 0.0
        for name in ("xy", "xz", "yz"):
            p = g[name]
            lv = lv + smooth_l1_sum(p[:, 1:, :], p[:, :-1, :])
            lv = lv + smooth_l1_sum(p[:, :, 1:], p[:, :, :-1])
        total = total + wl * lv / 6.0
    return total
