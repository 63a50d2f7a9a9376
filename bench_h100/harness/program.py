"""The system under test, splatco_torch, as the drivers call it: its
configuration, model state, cameras, training step and render entry,
built from the inputs the benchmark made.  The only harness module that
imports the program."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from bench_h100.harness import inputs
from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.contraction import make_contractor
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import ModelState, decode_kwargs
from splatco_torch.ops import cuda_lib
from splatco_torch.ops.losses import ssim
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import init_stats, make_train_step

__all__ = ["ssim", "cuda_lib", "Program"]


def optimization(o: Dict) -> OptimizationConfig:
    """The program's optimizer settings: the configuration's rates, every
    schedule over `max_steps`, the rest at the program's defaults."""
    fields = {f.name for f in dataclasses.fields(OptimizationConfig)}
    kw = {k: v for k, v in o.items() if k in fields}
    kw.update({f: o["max_steps"] for f in fields if f.endswith("_max_steps")})
    return OptimizationConfig(**kw)


class Program:
    """The program at one configuration (configs/<name>.json)."""

    def __init__(self, cfg: Dict, dev: torch.device):
        m, s, r = cfg["model"], inputs.scene(cfg), cfg["render"]
        self.dev = dev
        self.tile16 = r["tile"] == 16
        self.cfg = ModelConfig(
            sh_degree=m["sh_degree"], feat_dim=m["feat_dim"],
            n_offsets=m["n_offsets"], num_channels=m["num_channels"],
            plane_size=m["plane_size"], mlp_dim=m["mlp_dim"],
            appearance_dim=m["appearance_dim"], contractor=m["contractor"],
            bbox_scale=m["bbox_scale"], voxel_size=m["voxel_size"],
            update_init_factor=m["update_init_factor"],
            capacity=s["anchors"], scene_center=list(s["scene_center"]),
            scene_length=list(s["scene_length"]),
            white_background=s["white_background"], kmax=r["kmax"])
        self.opt = optimization(cfg["optimization"])
        self.bg = torch.tensor([1.0, 1.0, 1.0] if s["white_background"]
                               else [0.0, 0.0, 0.0], device=dev)
        self.state = ModelState(
            active=torch.ones(s["anchors"], dtype=torch.bool, device=dev),
            contractor=make_contractor(s["scene_center"], s["scene_length"],
                                       m["bbox_scale"],
                                       enabled=m["contractor"], device=dev),
            voxel_size=m["voxel_size"])

    def cameras(self, views: List[Dict]) -> list:
        return [look_at_camera(v["eye"], v["target"], v["up"], v["fovx"],
                               v["fovy"], v["width"], v["height"],
                               uid=v["uid"], device=self.dev) for v in views]

    def train_step(self, params, mv: int, level: int, q_noise: float,
                   extent: float, first_iteration: int):
        """(step, opt_state, stats): the SVC step with its multi-group
        Adam rebuilt at `first_iteration`: fresh moments, the schedules'
        counts at the iteration before it."""
        tx = make_optimizer(self.opt, params, extent, level, device=self.dev)
        opt_state = tx.init(params)
        opt_state["sched_count"] = {
            g: torch.full_like(c, first_iteration - 1)
            for g, c in opt_state["sched_count"].items()}
        stats = init_stats(params["anchors"]["anchor"].shape[0],
                           self.cfg.n_offsets, device=self.dev)
        step = make_train_step(self.cfg, self.opt, mv, level, tx,
                               q_noise=q_noise, device=self.dev,
                               tile16=self.tile16)
        return step, opt_state, stats

    def render(self, params, cam, level: int) -> torch.Tensor:
        """One frame as the render driver draws it: the anchor prefilter,
        then `render` (no gradient)."""
        with torch.inference_mode():
            vis = prefilter_voxel(params["anchors"], self.state.active, cam)
            return render(params, self.state.active, self.state.contractor,
                          cam, self.bg, visible_mask=vis,
                          activate_level=level, kmax=self.cfg.kmax,
                          tile16=self.tile16,
                          **decode_kwargs(self.cfg)).image

