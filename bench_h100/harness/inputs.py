"""Inputs made from the seed, shared by the program and the reference: the
model's weights (on the device, from torch.Generators there, in four
large draws), the orbit cameras and the smooth target images.

A configuration file (configs/<name>.json) gives the sizes: "model" the
published widths, "scene" the anchors (and whatever of SCENE it sets
otherwise), "render" the image and the rasterizer's tile and kmax.

The seed moves the scene: the anchors' points, features, offsets and
scales, the targets, the views and the noise.  The network (planes,
heads, decoders, TPA) comes from one fixed stream, the same for every
seed: its few thousand random decoder weights set the gaussians' sizes
and opacities, and so the records the blend walks, for all anchors at
once; a seed of their own would change the work from run to run.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# quaternion (w, x, y, z) of no rotation; the anchors' opacity logit
# (inverse sigmoid of 0.1), which the decode does not read
IDENTITY_QUAT = (1.0, 0.0, 0.0, 0.0)
ANCHOR_OPACITY_LOGIT = math.log(0.1 / 0.9)
# the network's stream
NETWORK_SEED = 1
# the random scene: N(0, point_sigma) points pulled inside point_radius of
# the centre; log-scales log(scale) + log_scale_sigma N(0, 1); features
# feat_sigma N(0, 1); offsets U(-1, 1) * offset_range; planes plane_sigma
# N(0, 1); the contraction box (scene_center, scene_length), as
# chip_smoke.py's.  A configuration's "scene" may set any of them.
SCENE = {"point_sigma": 1.0, "point_radius": 2.5, "scale": 0.05,
         "log_scale_sigma": 0.25, "feat_sigma": 0.5, "offset_range": 1.0,
         "plane_sigma": 0.1, "scene_center": [0.0, 0.0, 0.0],
         "scene_length": [4.0, 4.0, 4.0]}


def scene(cfg: Dict) -> Dict:
    """SCENE with the configuration's "scene" over it."""
    return {**SCENE, **cfg["scene"]}


def level_sizes(plane_size: int) -> List[int]:
    """The pyramid's plane sizes with the reference's duplicated level 0:
    [s/4, s/4, s/2]."""
    return [plane_size // 4, plane_size // 4, plane_size // 2]


def _linear(fan_in: int, fan_out: int):
    return [("w", (fan_in, fan_out), 1.0 / math.sqrt(fan_in)),
            ("b", (fan_out,), 1.0 / math.sqrt(fan_in))]


def leaf_specs(cfg: Dict) -> Dict[Tuple[str, str], list]:
    """{(stream, draw): [(path, shape, scale)]}: stream "scene" (from the
    seed) or "network" (NETWORK_SEED); a "normal" leaf is N(0, 1) *
    scale, a "uniform" one U(-1, 1) * scale."""
    m, s = cfg["model"], scene(cfg)
    c, f, k = s["anchors"], m["feat_dim"], m["n_offsets"]
    r = m["num_channels"] // 3
    specs = {("scene", "normal"): [
                 (("anchors", "anchor"), (c, 3), s["point_sigma"]),
                 (("anchors", "feat"), (c, f), s["feat_sigma"]),
                 (("anchors", "scaling"), (c, 6), s["log_scale_sigma"])],
             ("scene", "uniform"): [
                 (("anchors", "offsets"), (c, k, 3), s["offset_range"])],
             ("network", "normal"): [], ("network", "uniform"): []}
    normal, uniform = specs[("network", "normal")], specs[("network",
                                                           "uniform")]
    for lvl, size in enumerate(level_sizes(m["plane_size"])):
        for name in ("xy", "xz", "yz"):
            normal.append((("planes", "grids", lvl, name), (r, size, size),
                           s["plane_sigma"]))
    local = f + 3 + 2 * 32  # feat, view direction, geo_fea
    for name, out in (("opacity", k), ("cov", 7 * k), ("color", 3 * k)):
        for i, (a, b) in enumerate(((local, f), (f, out))):
            for leaf, shape, bound in _linear(a, b):
                uniform.append((("decoders", name, i, leaf), shape, bound))
    ctx_dim = f + 3 + 3 * k + 6
    for lvl in range(3):
        in_dim = 6 * r if lvl == 0 else 3 * r
        for kind, dim in (("heads", in_dim), ("ctx_heads", ctx_dim)):
            for leaf, shape, bound in _linear(dim, 32):
                uniform.append((("planes", kind, lvl, "lin", leaf), shape,
                                bound))
    hidden = 3 * r // 5
    uniform += [(("planes", "tpa", "ca_w1"), (3 * r, hidden),
                 1.0 / math.sqrt(3 * r)),
                (("planes", "tpa", "ca_w2"), (hidden, 3 * r),
                 1.0 / math.sqrt(hidden)),
                (("planes", "tpa", "sa_w"), (7, 7, 2, 1),
                 1.0 / math.sqrt(2 * 49))]
    return specs


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make_params(cfg: Dict, seed: int, dev: torch.device) -> Dict:
    """The parameter tree in the port's layout, from four draws of
    generators on `dev` (the scene's from `seed`, the network's from
    NETWORK_SEED): anchors at N(0, point_sigma) pulled inside
    point_radius, on the voxel grid, log-normal scales, uniform offsets,
    N(0, 1) features scaled, planes N(0, plane_sigma), every linear map
    U(+-1/sqrt(fan_in)) (also the levels above 0, as in a trained model),
    BatchNorm scale 1 and bias 0, the anchors unrotated."""
    s = scene(cfg)
    gens = {"scene": torch.Generator(device=dev).manual_seed(seed),
            "network": torch.Generator(device=dev).manual_seed(NETWORK_SEED)}
    tree: Dict = {}
    for (stream, draw), specs in leaf_specs(cfg).items():
        total = sum(math.prod(shape) for _, shape, _ in specs)
        if draw == "normal":
            flat = torch.randn(total, generator=gens[stream], device=dev)
        else:
            flat = (torch.rand(total, generator=gens[stream], device=dev)
                    * 2.0 - 1.0)
        at = 0
        for path, shape, scale in specs:
            n = math.prod(shape)
            _put(tree, path, flat[at:at + n].view(shape) * scale)
            at += n
    a = tree["anchors"]
    voxel = cfg["model"]["voxel_size"]
    # inside `point_radius` of the centre, so that every point lies well in
    # front of every orbit camera: a gaussian at a camera's plane has an
    # infinite projection Jacobian, and its zero cotangent times that is
    # a NaN gradient (in the program and in the reference alike)
    p = a["anchor"]
    r = torch.linalg.vector_norm(p, dim=1, keepdim=True)
    p = p * torch.clamp_max(s["point_radius"] / r, 1.0)
    a["anchor"] = torch.round(p / voxel) * voxel
    a["scaling"] = a["scaling"] + math.log(s["scale"])
    c = a["anchor"].shape[0]
    a["rotation"] = torch.tensor(IDENTITY_QUAT, device=dev).repeat(c, 1)
    a["opacity"] = torch.full((c, 1), ANCHOR_OPACITY_LOGIT, device=dev)
    tree["anchors"] = {key: a[key] for key in ("anchor", "feat", "offsets",
                                               "scaling", "rotation",
                                               "opacity")}
    r = cfg["model"]["num_channels"] // 3
    ctx_dim = cfg["model"]["feat_dim"] + 3 + 3 * cfg["model"]["n_offsets"] + 6
    for lvl in range(3):
        for kind, dim in (("heads", 6 * r if lvl == 0 else 3 * r),
                          ("ctx_heads", ctx_dim)):
            head = tree["planes"][kind][lvl]
            tree["planes"][kind][lvl] = {
                "bn": {"scale": torch.ones(dim, device=dev),
                       "bias": torch.zeros(dim, device=dev)},
                "lin": head["lin"]}
    return tree


def orbit(cfg: Dict, traffic: Dict) -> List[Dict]:
    """The orbit: `cameras` views on a circle around the scene centre,
    each (eye, target, up, fovx, fovy, width, height, uid)."""
    o, r = traffic["orbit"], cfg["render"]
    n = traffic["cameras"]
    fovx = o["fovx"]
    return [dict(eye=[o["radius"] * math.sin(2 * math.pi * i / n),
                      o["height"],
                      -o["radius"] * math.cos(2 * math.pi * i / n)],
                 target=[0.0, 0.0, 0.0], up=[0.0, -1.0, 0.0], fovx=fovx,
                 fovy=fovx * r["height"] / r["width"], width=r["width"],
                 height=r["height"], uid=i) for i in range(n)]


def smooth_targets(cfg: Dict, n: int, seed: int, dev: torch.device
                   ) -> List[torch.Tensor]:
    """n target images [3, H, W] in [0, 1]: four low-frequency waves a
    channel shared by every view and one weak wave a channel of each
    view's own, so that views' pairwise SSIM passes the consistency
    gate.  The waves' parameters come from numpy's generator, the pixels
    are made on `dev`."""
    w, h = cfg["render"]["width"], cfg["render"]["height"]
    rng = np.random.default_rng(seed)
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    x = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    def wave(amp):
        fx, fy = rng.uniform(-6.0, 6.0, 2) * 2 * math.pi / np.array([w, h])
        phase = rng.uniform(0.0, 2 * math.pi)
        return float(amp) * torch.sin(float(fx) * x + float(fy) * y + phase)

    base = torch.stack([0.5 + sum(wave(rng.uniform(0.05, 0.15))
                                  for _ in range(4)) for _ in range(3)])
    return [torch.clamp(base + torch.stack([wave(0.03) for _ in range(3)]),
                        0.0, 1.0) for _ in range(n)]


def scene_bounds(cfg: Dict, dev: torch.device):
    """The contraction box: centre +- length * bbox_scale / 2."""
    s = scene(cfg)
    center = torch.tensor(s["scene_center"], dtype=torch.float32, device=dev)
    length = torch.tensor(s["scene_length"], dtype=torch.float32, device=dev)
    half = length * cfg["model"]["bbox_scale"] / 2.0
    return center - half, center + half
