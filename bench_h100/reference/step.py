"""The reference's render and SVC training step.

`render_view` decodes, projects, bins and blends one view.
`RefTrainer.step` is one SVC step: mv views (one plane sampling shared,
each view its own quantization noise), the per-view L1 / SSIM / scale
term, the gated pairwise consistency, the TV term, one backward by
autograd, and the multi-group Adam (eps 1e-15) with the per-group
learning-rate schedules.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_h100.reference import model as rm
from bench_h100.reference.numerics import Numerics
from bench_h100.reference.project import project, visible
from bench_h100.reference.raster import rasterize

LAMBDA_DSSIM = 0.2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
CONSISTENCY_W, GATE = 0.05, 0.6


def render_view(params, bounds, cam, bg, vis, level: int, tile: int,
                kmax: int, num: Numerics, feats=None, q: float = 0.0,
                generator=None):
    """(image [3, H, W], decoded gaussians, binned records)."""
    g = rm.decode(params, bounds[0], bounds[1], cam.center, vis, level, num,
                  feats=feats, q=q, generator=generator)
    cols = project(g["xyz"], g["scaling"], g["rot"], cam)
    cols = cols._replace(radius=torch.where(g["opacity"] > 0.0, cols.radius,
                                            0.0))
    img, binned = rasterize(cols, g["color"], g["opacity"], bg, cam.width,
                            cam.height, tile, kmax)
    return img, g, binned


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, num: Numerics) -> torch.Tensor:
    """Mean windowed SSIM (11 x 11 Gaussian, sigma 1.5, zero padding,
    C1 = 0.01^2, C2 = 0.03^2) of two [3, H, W] images."""
    g = torch.as_tensor(_window(), device=a.device)
    w = (g[:, None] * g[None, :])[None, None].expand(3, 1, 11, 11)

    def blur(x):
        return num.conv2d(x[None], w.contiguous(), padding=5, groups=3)[0]

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def rebuild(flat: Dict[str, torch.Tensor], like):
    """The tree of `like` with the leaves of `flat`."""
    def go(node, prefix):
        if isinstance(node, dict):
            return {k: go(v, f"{prefix}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [go(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return flat[prefix]
    return go(like, "")


def group_of(path: str, level: int) -> str:
    """A leaf's learning-rate group (the port's and the JAX package's
    labels): anchor fields, decoder MLPs, plane grids (TPA with level 0),
    fusion heads; the context heads are frozen."""
    parts = path.strip("/").split("/")
    if parts[0] == "anchors":
        return {"anchor": "anchor", "offsets": "offset", "feat": "anchor_feat",
                "opacity": "opacity", "scaling": "scaling",
                "rotation": "rotation"}[parts[1]]
    if parts[0] == "decoders":
        return "mlp_" + parts[1]
    if parts[1] == "tpa":
        return "planes0"
    kind = {"grids": "planes", "heads": "plane_head",
            "ctx_heads": "ctx_head"}[parts[1]]
    return f"{kind}{parts[2]}"


def _expon(step: float, lr_init: float, lr_final: float, max_steps: int
           ) -> float:
    """The log-linear schedule (no delay ramp), in float32."""
    f = np.float32
    t = f(min(max(step / max_steps, 0.0), 1.0))
    v = np.exp(np.log(f(max(lr_init, 1e-30))) * (f(1) - t)
               + np.log(f(max(lr_final, 1e-30))) * t)
    return float(f(v)) if step >= 0 else 0.0


def learning_rates(opt: Dict[str, float], extent: float, level: int,
                   sched_count: int) -> Dict[str, float]:
    """Each group's learning rate at schedule count `sched_count`."""
    ex = _expon
    n = opt["max_steps"]
    lr = {
        "anchor": ex(sched_count, opt["position_lr_init"] * extent,
                     opt["position_lr_final"] * extent, n),
        "offset": ex(sched_count, opt["offset_lr_init"] * extent,
                     opt["offset_lr_final"] * extent, n),
        "anchor_feat": opt["feature_lr"], "opacity": opt["opacity_lr"],
        "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
        "mlp_opacity": ex(sched_count, opt["mlp_opacity_lr_init"],
                          opt["mlp_opacity_lr_final"], n),
        "mlp_cov": ex(sched_count, opt["mlp_cov_lr_init"],
                      opt["mlp_cov_lr_final"], n),
        "mlp_color": ex(sched_count, opt["mlp_color_lr_init"],
                        opt["mlp_color_lr_final"], n),
    }
    for i in range(3):
        act = i == level
        lr[f"planes{i}"] = opt["plane_lr_active" if act
                               else "plane_lr_inactive"]
        lr[f"plane_head{i}"] = opt["plane_mlp_lr_active" if act
                                   else "plane_mlp_lr_inactive"]
        lr[f"ctx_head{i}"] = 0.0
    return lr


class RefTrainer:
    """The reference's training state: params, Adam moments and counts,
    driven one SVC step at a time."""

    def __init__(self, params, active, bounds, bg, cfg: Dict, opt: Dict,
                 extent: float, first_iteration: int, num: Numerics):
        self.params = {k: v.detach().clone()
                       for k, v in leaves(params).items()}
        self.like = params
        self.active, self.bounds, self.bg = active, bounds, bg
        self.cfg, self.opt, self.extent, self.num = cfg, opt, extent, num
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.sched_count = first_iteration - 1

    def tree(self):
        return rebuild(self.params, self.like)

    def step(self, cams: List, gts: List[torch.Tensor], gates: List[float],
             consistency_on: float, tv_w: float, generator) -> Dict:
        """One SVC step; returns {"loss": float, "grads": {path: tensor}}."""
        cfg, num = self.cfg, self.num
        level = cfg["activate_level"]
        flat = {k: v.detach().requires_grad_() for k, v in self.params.items()}
        tree = rebuild(flat, self.like)
        anchors = tree["anchors"]
        vis = [visible(anchors, self.active, cam) for cam in cams]
        feats = rm.level_feats(tree["planes"],
                               rm.plane_coords(anchors["anchor"],
                                               *self.bounds), level, num)
        total = 0.0
        images = []
        for cam, gt, vm in zip(cams, gts, vis):
            img, g, _ = render_view(tree, self.bounds, cam, self.bg, vm, level,
                                    cfg["tile"], cfg["kmax"], num, feats=feats,
                                    q=cfg["q_noise"], generator=generator)
            ll1 = (img - gt).abs().mean()
            m = g["mask"].to(torch.float32)
            sreg = ((torch.prod(g["scaling"], dim=1) * m).sum()
                    / torch.clamp_min(m.sum(), 1.0))
            total = total + ((1.0 - LAMBDA_DSSIM) * ll1
                             + LAMBDA_DSSIM * (1.0 - ssim(img, gt, num))
                             + 0.01 * sreg)
            images.append(img)
        con = 0.0
        pidx = 0
        for i in range(len(cams)):
            for j in range(i + 1, len(cams)):
                gate = gates[pidx]
                pidx += 1
                if gate > GATE:
                    diff = ((gts[i] - gts[j]) - (images[i] - images[j])
                            ).abs().mean()
                    con = con + gate * diff.abs()
        total = total + consistency_on * CONSISTENCY_W * con
        if tv_w:
            total = total + rm.tv(tree["planes"], level) * tv_w
        keys = list(flat)
        grads = torch.autograd.grad(total, [flat[k] for k in keys],
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(flat[k]))
                 for k, g in zip(keys, grads)}
        self._adam(grads)
        return {"loss": float(total.detach()), "grads": grads}

    def _adam(self, grads: Dict[str, torch.Tensor]) -> None:
        level = self.cfg["activate_level"]
        lr = learning_rates(self.opt, self.extent, level, self.sched_count)
        self.count += 1
        bc1 = 1.0 - ADAM_B1 ** self.count
        bc2 = 1.0 - ADAM_B2 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
                nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[k]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                self.params[k] = self.params[k] - lr[group_of(k, level)] * u
                self.mu[k], self.nu[k] = mu, nu
        self.sched_count += 1


def scene_extent(cams: List) -> float:
    """1.1 x the largest distance of a camera from the cameras' mean
    centre (the spatial learning rates' scale)."""
    c = torch.stack([cam.center for cam in cams]).double()
    return 1.1 * float((c - c.mean(dim=0)).norm(dim=1).max())


def eight_bit(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] in [0, 1] -> [H, W, 3] uint8, truncated as the render
    driver's PNGs are."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(
        1, 2, 0).contiguous()

