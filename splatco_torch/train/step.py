"""SVC training step: multi-view render, one aggregated backward
(counterpart of splatco_tpu/train/step.py with `backend="pallas"`).

The step renders mv views, sums the per-view losses
    (1 - lambda) * L1 + lambda * (1 - SSIM) + 0.01 * mean(prod(scaling))
over the selected gaussians, adds the pairwise consistency term
    ssim(gt_i, gt_j) * | mean|(gt_i - gt_j) - (ren_i - ren_j)| |
(gated on ssim(gt_i, gt_j) > 0.6, weighted 0.05, views of unequal size
crop-aligned to their common top-left window) and the TV term on the
active plane levels, and runs ONE backward, so the structural (tri-plane)
and per-view pixel gradients aggregate before the Adam step.  The
tri-plane sampling is shared by the views; each view adds its own
quantization noise.

The densification statistics follow the reference quirk of using only the
LAST view's render outputs, with the screen-space gradient scaled to NDC
units, (0.5 W, 0.5 H), before its norm.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.models.contraction import Contractor
from splatco_torch.models.renderer import (precompute_plane_feats,
                                           prefilter_voxel, render)
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.models.triplane import tv_loss
from splatco_torch.ops.losses import l1_loss, ssim
from splatco_torch.train.optimizer import Optimizer, tree_leaves, tree_map
from splatco_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainStats:
    """Densification statistics (the reference's training_statis state)."""
    opacity_accum: torch.Tensor          # [C,1]
    anchor_demon: torch.Tensor           # [C,1]
    offset_gradient_accum: torch.Tensor  # [C*K,1]
    offset_denom: torch.Tensor           # [C*K,1]


def init_stats(capacity: int, n_offsets: int, device=None) -> TrainStats:
    dev = resolve_device(device)
    z = lambda n: torch.zeros((n, 1), device=dev)  # noqa: E731
    return TrainStats(opacity_accum=z(capacity), anchor_demon=z(capacity),
                      offset_gradient_accum=z(capacity * n_offsets),
                      offset_denom=z(capacity * n_offsets))


def make_train_step(cfg: ModelConfig, opt: OptimizationConfig, mv: int,
                    activate_level: int, tx: Optimizer,
                    q_noise: float = 0.03, device=None,
                    tile16: Optional[bool] = None) -> Callable:
    """The SVC step for a fixed activate_level and mv, with the optimizer
    `tx` (train/optimizer.make_optimizer), running on `device` (default
    the card).  `tile16` picks the rasterizer configuration
    (ops/rasterize.py; None: the SPLATCO_RASTER switch).

    step(params, opt_state, active, contractor, stats, cameras, gts, bg,
         generator, iteration, consistency_on, tv_w, stats_on,
         pair_gates=None, stage=None) -> (params, opt_state, stats, metrics)

    `generator` (a torch.Generator on the device) draws the views'
    quantization noise.  `iteration` is not read: the LR schedules read
    the optimizer's counts, as in the JAX package.  `pair_gates` are
    optional precomputed SSIM gates of the consistency pairs (i < j in
    row-major order; None computes them in the step).  `stage(name)`,
    when given, returns a context manager wrapped around each phase
    ("planes", "forward_view<i>", "losses", "backward", "stats", "adam"),
    for timing.  The inputs are not modified."""
    dev = resolve_device(device)
    dkw = decode_kwargs(cfg)
    lam = opt.lambda_dssim

    def step(params, opt_state, active: torch.Tensor,
             contractor: Contractor, stats: TrainStats,
             cameras: Sequence, gts: Sequence[torch.Tensor],
             bg: torch.Tensor, generator: Optional[torch.Generator],
             iteration, consistency_on, tv_w, stats_on,
             pair_gates: Optional[torch.Tensor] = None,
             stage: Optional[Callable[[str], Any]] = None):
        del iteration
        phase = stage or (lambda name: contextlib.nullcontext())
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        c = leaves["anchors"]["anchor"].shape[0]
        k = cfg.n_offsets
        with torch.no_grad():
            vis_masks = [prefilter_voxel(leaves["anchors"], active, cam)
                         for cam in cameras]
        proxy = torch.zeros((c * k, 2), device=dev, requires_grad=True)

        total = 0.0
        images = []
        max_slots = torch.zeros((), dtype=torch.int64, device=dev)
        num_clipped = torch.zeros((), dtype=torch.int64, device=dev)
        with phase("planes"):
            plane_feats = precompute_plane_feats(
                leaves, contractor, activate_level,
                compat_raw_domain=dkw.get("compat_raw_domain", False))
        for i in range(mv):
            with phase(f"forward_view{i}"):
                out = render(
                    leaves, active, contractor, cameras[i], bg,
                    visible_mask=vis_masks[i],
                    viewspace_proxy=proxy if i == mv - 1 else None,
                    activate_level=activate_level, is_training=True,
                    q_noise=q_noise, generator=generator, kmax=cfg.kmax,
                    plane_feats=plane_feats, tile16=tile16, **dkw)
            with phase("losses"):
                max_slots = torch.maximum(max_slots, out.max_slots)
                num_clipped = num_clipped + out.num_clipped
                ll1 = l1_loss(out.image, gts[i])
                ssim_l = 1.0 - ssim(out.image, gts[i])
                m = out.selection_mask.to(torch.float32)
                sreg = ((torch.prod(out.scaling, dim=1) * m).sum()
                        / torch.clamp_min(m.sum(), 1.0))
                total = total + ((1.0 - lam) * ll1 + lam * ssim_l
                                 + 0.01 * sreg)
            images.append(out.image)

        with phase("losses"):
            con = torch.zeros((), device=dev)
            pidx = 0
            for i in range(mv):
                for j in range(i + 1, mv):
                    mh = min(gts[i].shape[-2], gts[j].shape[-2])
                    mw = min(gts[i].shape[-1], gts[j].shape[-1])
                    gi, gj = gts[i][..., :mh, :mw], gts[j][..., :mh, :mw]
                    gate = (ssim(gi, gj) if pair_gates is None
                            else pair_gates[pidx])
                    pidx += 1
                    diff = l1_loss(gi - gj, images[i][..., :mh, :mw]
                                   - images[j][..., :mh, :mw])
                    con = con + torch.where(gate > 0.6, gate * diff.abs(),
                                            0.0)
            total = total + consistency_on * 0.05 * con
            total = total + tv_loss(leaves["planes"], 1.0,
                                    activate_level) * tv_w

        with phase("backward"):
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(total, flat + [proxy],
                                        allow_unused=True)
            # what the loss does not reach (inactive levels, frozen heads,
            # a view with no gaussian) gets zero gradients, as jax.grad
            # gives it
            grads = [g if g is not None else torch.zeros_like(p)
                     for p, g in zip(flat + [proxy], grads)]
            proxy_grad = grads[-1]
            it = iter(grads[:-1])
            grads = tree_map(lambda _: next(it), leaves)

        with phase("stats"):
            vis_anchor = vis_masks[-1][:, None]
            neur_op = torch.clamp_min(out.neural_opacity.detach(),
                                      0.0).reshape(c, k)
            slot_mask = (out.selection_mask & out.visibility_filter)[:, None]
            cam = cameras[-1]
            gscale = torch.tensor([0.5 * cam.image_width,
                                   0.5 * cam.image_height],
                                  dtype=torch.float32, device=dev)
            gnorm = torch.linalg.vector_norm(proxy_grad * gscale, dim=-1,
                                             keepdim=True)
            stats = TrainStats(
                opacity_accum=stats.opacity_accum + stats_on * torch.where(
                    vis_anchor, neur_op.sum(dim=1, keepdim=True), 0.0),
                anchor_demon=stats.anchor_demon + stats_on * torch.where(
                    vis_anchor, 1.0, 0.0),
                offset_gradient_accum=stats.offset_gradient_accum
                + stats_on * torch.where(slot_mask, gnorm, 0.0),
                offset_denom=stats.offset_denom
                + stats_on * torch.where(slot_mask, 1.0, 0.0))

        with phase("adam"):
            new_params, opt_state = tx.update(grads, opt_state, params)
        metrics: Dict[str, Any] = {
            "loss": total.detach(), "l1": ll1.detach(), "con": con.detach(),
            "num_overflow": 0, "max_slots": max_slots,
            "num_clipped": num_clipped}
        return new_params, opt_state, stats, metrics

    return step
