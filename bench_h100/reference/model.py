"""The reference's cameras and its neural-gaussian decode: scene
contraction, the CSCM tri-plane pyramid (bilinear samples, TriPlane
Attention, masked train-mode BatchNorm fusion heads) and the opacity,
colour and covariance MLPs, for every anchor row at once."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_h100.reference.numerics import Numerics


@dataclasses.dataclass(frozen=True)
class RefCamera:
    """A pinhole view in the 3DGS row-vector convention: `view` and
    `full` are the transposed world->view and world->clip matrices."""
    view: torch.Tensor    # [4, 4]
    full: torch.Tensor    # [4, 4]
    center: torch.Tensor  # [3]
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    uid: int


def look_at(eye, target, up, fovx: float, fovy: float, width: int,
            height: int, uid: int, device, znear: float = 0.01,
            zfar: float = 100.0) -> RefCamera:
    """The camera at `eye` looking at `target` (+x right, +y down, +z
    forward in camera space); matrices built in float64, stored float32."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = eye
    w2v = np.float32(np.linalg.inv(c2w)).T
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = 1.0 / ty
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj = np.float32(proj).T
    full = (w2v @ proj).astype(np.float32)
    center = np.linalg.inv(w2v)[3, :3].astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return RefCamera(t(w2v), t(full), t(center), width, height, tx, ty, uid)


def contract(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
             ) -> torch.Tensor:
    """MERF contraction: the box [lo, hi] onto [-1, 1], the outside warped
    into (-2, -1] and [1, 2) by sign(x) (2 - 1 / |x|)."""
    ind = (xyz - lo) * 2.0 / (hi - lo) - 1.0
    a = torch.abs(ind)
    warped = torch.sign(ind) * (2.0 - 1.0 / torch.clamp_min(a, 1.0))
    return torch.where(a > 1.0, warped, ind)


def sample_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """Bilinear sample of plane [R, H, W] at u (H axis) and v (W axis) in
    [-1, 1], align_corners, zeros outside: [N, R]."""
    r, h, w = plane.shape
    flat = plane.reshape(r, h * w)
    x = (u + 1.0) * 0.5 * (h - 1)
    y = (v + 1.0) * 0.5 * (w - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    out = None
    for k in range(4):
        sx, sy = k & 1, k & 2
        cx = x0 + 1 if sx else x0
        cy = y0 + 1 if sy else y0
        wgt = (tx if sx else 1 - tx) * (ty if sy else 1 - ty)
        inb = (cx >= 0) & (cx <= h - 1) & (cy >= 0) & (cy <= w - 1)
        idx = (torch.clamp(cx, 0, h - 1).to(torch.int64) * w
               + torch.clamp(cy, 0, w - 1).to(torch.int64))
        term = flat[:, idx] * (wgt * inb.to(plane.dtype))[None, :]
        out = term if out is None else out + term
    return out.T


def tpa(p: Dict[str, torch.Tensor], x: torch.Tensor, num: Numerics
        ) -> torch.Tensor:
    """TriPlaneAttention of the stacked planes x [C, H, W]: channel
    attention (shared two-layer map of the mean and the max), then a 7x7
    spatial attention over [mean, max] across channels."""
    def shared(v):
        return num.mm(torch.relu(num.mm(v[None], p["ca_w1"])), p["ca_w2"])[0]

    ca = torch.sigmoid(shared(x.mean(dim=(1, 2))) + shared(x.amax(dim=(1, 2))))
    x = x * ca[:, None, None]
    sa_in = torch.stack([x.mean(dim=0), x.amax(dim=0)])[None]
    weight = p["sa_w"].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    sa = num.conv2d(sa_in, weight, padding=3)
    return x * torch.sigmoid(sa[0, 0])[None]


def masked_bn(p, x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Train-mode BatchNorm over the rows of x [N, D] that `mask` keeps
    (biased variance E[x^2] - mean^2)."""
    m = mask.to(x.dtype)[:, None]
    cnt = torch.clamp_min(m.sum(), 1.0)
    mean = (x * m).sum(dim=0) / cnt
    var = torch.clamp_min(((x * x) * m).sum(dim=0) / cnt - mean * mean, 0.0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def linear(p, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    return num.mm(x, p["w"]) + p["b"]


def mlp(layers: List, x: torch.Tensor, num: Numerics, final: str
        ) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = linear(layer, x, num)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return torch.tanh(x) if final == "tanh" else (
        torch.sigmoid(x) if final == "sigmoid" else x)


def plane_coords(anchor: torch.Tensor, lo, hi) -> torch.Tensor:
    return contract(anchor, lo, hi) * 2.0


def level_feats(planes, xyz_norm: torch.Tensor, level: int, num: Numerics):
    """Per active level, (the three planes' samples, level 0's samples of
    the attention-weighted planes or None)."""
    fx, fy, fz = (xyz_norm[:, i] / 2.0 for i in range(3))
    out = []
    for i in range(level + 1):
        g = planes["grids"][i]
        feats = [sample_plane(g["xy"], fx, fy), sample_plane(g["xz"], fx, fz),
                 sample_plane(g["yz"], fy, fz)]
        ta = None
        if i == 0:
            r = g["xy"].shape[0]
            att = tpa(planes["tpa"], torch.cat([g["xy"], g["xz"], g["yz"]]),
                      num)
            ta = [sample_plane(att[:r], fx, fy),
                  sample_plane(att[r:2 * r], fx, fz),
                  sample_plane(att[2 * r:], fy, fz)]
        out.append((feats, ta))
    return out


def noisy(feats: List[torch.Tensor], q: float,
          generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """feats + U(-1/2, 1/2) q, one draw of each feature's shape from
    `generator` in turn (the training step's quantization noise)."""
    if q <= 0.0 or generator is None:
        return feats
    return [f + (torch.rand(f.shape, generator=generator, device=f.device,
                            dtype=f.dtype) - 0.5) * q for f in feats]


def decode(params, lo, hi, center: torch.Tensor, vis: torch.Tensor,
           level: int, num: Numerics, feats=None, q: float = 0.0,
           generator: Optional[torch.Generator] = None):
    """Anchors -> their K gaussians each: xyz, colour, opacity (0 where
    masked), scaling, rotation, the raw opacity and the mask (opacity > 0
    and the anchor visible)."""
    a = params["anchors"]
    anchor, feat, offsets = a["anchor"], a["feat"], a["offsets"]
    c, k, _ = offsets.shape
    gscale = torch.exp(a["scaling"])
    xyz_norm = plane_coords(anchor, lo, hi)
    if feats is None:
        feats = level_feats(params["planes"], xyz_norm, level, num)
    ctx_in = torch.cat([feat, anchor, offsets.reshape(c, -1), gscale], dim=1)
    planes = params["planes"]
    geo = None
    for i in range(level + 1):
        f, ta = feats[i]
        f = noisy(f, q, generator)
        if i == 0:
            ta = noisy(ta, q, generator)
            x = torch.cat([f[0], ta[0], f[1], ta[1], f[2], ta[2]], dim=-1)
        else:
            x = torch.cat(f, dim=-1)
        head, ctx = planes["heads"][i], planes["ctx_heads"][i]
        res = torch.cat([linear(head["lin"], masked_bn(head["bn"], x, vis),
                                num),
                         linear(ctx["lin"], masked_bn(ctx["bn"], ctx_in, vis),
                                num)], dim=-1)
        geo = res if geo is None else geo + res
    ob = anchor - center
    dist = torch.linalg.vector_norm(ob, dim=1, keepdim=True)
    ob = ob / torch.clamp_min(dist, 1e-12)
    local = torch.cat([feat, ob, geo], dim=1)
    dec = params["decoders"]
    raw_op = mlp(dec["opacity"], local, num, "tanh").reshape(-1)
    mask = (raw_op > 0.0) & vis.repeat_interleave(k)
    opacity = torch.where(mask, raw_op, 0.0)
    color = mlp(dec["color"], local, num, "sigmoid").reshape(c * k, 3)
    sr = mlp(dec["cov"], local, num, "").reshape(c * k, 7)

    def rep(t):
        return t[:, None].expand(c, k, t.shape[1]).reshape(c * k, -1)

    srep = rep(gscale)
    scaling = srep[:, 3:] * torch.sigmoid(sr[:, :3])
    q4 = sr[:, 3:7]
    rot = q4 / torch.clamp_min(torch.linalg.vector_norm(q4, dim=-1,
                                                        keepdim=True), 1e-12)
    xyz = rep(anchor) + offsets.reshape(c * k, 3) * srep[:, :3]
    return {"xyz": xyz, "color": color, "opacity": opacity,
            "scaling": scaling, "rot": rot, "raw_opacity": raw_op,
            "mask": mask}


def tv(planes, level: int) -> torch.Tensor:
    """The TV term over the active levels: smooth-L1 of adjacent texel
    differences, the mean of the six axis terms, weighted 0.5^(2-level)."""
    def sl1(d):
        ad = d.abs()
        return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum()

    total = 0.0
    for lvl in range(level + 1):
        g = planes["grids"][lvl]
        lv = 0.0
        for name in ("xy", "xz", "yz"):
            p = g[name]
            lv = lv + sl1(p[:, 1:, :] - p[:, :-1, :])
            lv = lv + sl1(p[:, :, 1:] - p[:, :, :-1])
        total = total + (0.5 ** (2 - lvl)) * lv / 6.0
    return total
