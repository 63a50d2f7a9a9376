"""The sharded training loop beside the single-device trajectory (the
counterpart of __graft_entry__.py's `dryrun_multichip`).

On a (view, gauss) mesh, `sharded_loop` takes `steps` sharded SVC steps
with the scripted events of a training run:
  * densify (adjust_anchor) at `densify_at`, with a tiny gradient
    threshold so the accumulated statistics grow anchors: every rank
    gathers the full state over gauss, takes the same densify with the
    same draws and keeps its slice again,
  * one capacity regrowth after the densify at `regrow_after` (rows,
    Adam moments and statistics kept, re-sharded),
  * one activate_level bump at `activate_at` (the optimizer rebuilt),
while rank 0 runs the single-device step (mv = n_view) in lockstep on
the same views; after each densify the single trajectory adopts the
sharded state, so the per-step losses compare the step's decomposition,
not densify's voxel-boundary sensitivity.  Every step runs at q = 0.

`step_gradients` gives one sharded step's whole gradient and metrics, to
hold one backend against another, and `single_gradients` the
single-device step's, to hold the strips against the whole view.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.models.anchors import grow_capacity, pad_rows
from splatco_torch.ops import cuda_lib
from splatco_torch.parallel.mesh import (STAT_FIELDS, Mesh, gather_rows,
                                         shard_params, unshard_params)
from splatco_torch.parallel.train_step import make_sharded_train_step
from splatco_torch.train.densify import adjust_anchor
from splatco_torch.train.optimizer import (Optimizer, make_optimizer,
                                           tree_map)
from splatco_torch.train.step import TrainStats, init_stats, make_train_step

# consistency_on, tv_w, stats_on of the loop's steps
TERMS = (1.0, 0.0, 1.0)


def _zero_stats(stats: TrainStats) -> TrainStats:
    return TrainStats(**{f: torch.zeros_like(getattr(stats, f))
                         for f in STAT_FIELDS})


class ShardedTrajectory:
    """This rank's shards of one trajectory on the mesh; `build` makes the
    step for the current level and optimizer."""

    def __init__(self, mesh: Mesh, cfg: ModelConfig, params, active,
                 backend: str, device, terms=TERMS, level: int = 0):
        self.mesh, self.cfg, self.backend = mesh, cfg, backend
        self.dev, self.terms, self.level = device, terms, level
        self.opt = OptimizationConfig()
        tx = make_optimizer(self.opt, params, 1.0, level, device=device)
        stats = init_stats(params["anchors"]["anchor"].shape[0],
                           cfg.n_offsets, device=device)
        self.place(params, tx.init(params), active, stats)
        self.build(tx)

    def place(self, params, opt_state, active, stats):
        self.params, self.opt_state, self.active, self.stats = shard_params(
            self.mesh, params, opt_state, active, stats)

    def full(self):
        """The full state (a collective over gauss)."""
        return unshard_params(self.mesh, self.params, self.opt_state,
                              self.active, self.stats)

    def build(self, tx):
        self.fn = make_sharded_train_step(
            self.cfg, self.opt, self.mesh, tx, activate_level=self.level,
            backend=self.backend, q_noise=0.0, device=self.dev)

    def step(self, contractor, cam, gt, view_geom=None, carry=None):
        """One step from `carry` (default the trajectory's state), which
        becomes the trajectory's state."""
        carry = carry or (self.params, self.opt_state, self.stats)
        out = self.fn(carry[0], carry[1], self.active, contractor, carry[2],
                      cam, gt, 0, *self.terms, view_geom=view_geom)
        self.params, self.opt_state, self.stats = out[:3]
        return out


class SingleTrajectory:
    """The single-device trajectory on the full state."""

    def __init__(self, cfg: ModelConfig, full, backend: str, device,
                 n_view: int, terms=TERMS, level: int = 0):
        self.cfg, self.backend, self.dev = cfg, backend, device
        self.n_view, self.terms, self.level = n_view, terms, level
        self.opt = OptimizationConfig()
        self.params, self.opt_state, self.active, self.stats = full
        self.build(make_optimizer(self.opt, self.params, 1.0, level,
                                  device=device))

    def build(self, tx):
        self.fn = make_train_step(self.cfg, self.opt, self.n_view,
                                  self.level, tx, q_noise=0.0,
                                  device=self.dev, backend=self.backend)

    def step(self, contractor, cams, gts):
        bg = torch.tensor([1.0, 1.0, 1.0] if self.cfg.white_background
                          else [0.0, 0.0, 0.0], device=self.dev)
        out = self.fn(self.params, self.opt_state, self.active, contractor,
                      self.stats, cams, list(gts), bg, None, 0, *self.terms)
        self.params, self.opt_state, self.stats = out[:3]
        return out


def densify(full, it: int, n_offsets: int, voxel_size: float):
    """adjust_anchor on a full state with draws seeded by the iteration,
    so every rank takes the same one: (new full state, [grown, pruned,
    active])."""
    params, opt_state, active, stats = full
    c = params["anchors"]["anchor"].shape[0]
    dev = active.device
    draws = torch.rand((3, c * n_offsets),
                       generator=torch.Generator().manual_seed(7000 + it)
                       ).to(dev)
    res = adjust_anchor(params, opt_state, active, stats, draws, voxel_size,
                        1e-7, torch.zeros(c * n_offsets, dtype=torch.bool,
                                          device=dev),
                        torch.zeros(c, dtype=torch.bool, device=dev),
                        check_interval=10)
    counts = torch.stack([res.num_grown, res.num_pruned,
                          res.num_active]).tolist()
    return (res.params, res.opt_state, res.active, res.stats), counts


def regrow(full, n_offsets: int):
    """The capacity doubled: the anchors' rows, their Adam moments and the
    statistics kept, new rows zero."""
    params, opt_state, active, stats = full
    c2 = 2 * params["anchors"]["anchor"].shape[0]
    anchors, active = grow_capacity(params["anchors"], active, c2)

    def pad(tree):
        return {n: pad_rows(a, c2) for n, a in tree.items()}

    opt_state = dict(opt_state, **{
        m: dict(opt_state[m], anchors=pad(opt_state[m]["anchors"]))
        for m in ("mu", "nu")})
    stats = TrainStats(**{
        f: pad_rows(getattr(stats, f),
                    c2 * (n_offsets if f.startswith("offset") else 1))
        for f in STAT_FIELDS})
    return dict(params, anchors=anchors), opt_state, active, stats


def sharded_loop(mesh: Mesh, cfg: ModelConfig, params, active, contractor,
                 cams: Sequence, gts: Sequence[torch.Tensor], backend: str,
                 device, steps: int = 24, densify_at=(10, 20),
                 regrow_after: int = 10, activate_at: int = 14,
                 voxel_size: float = 0.05) -> Dict[str, list]:
    """Run the loop (module docstring) on every rank of `mesh` with the
    n_view views `cams` / `gts`.  Returns the sharded trajectory's loss
    per step, rank 0's single-device losses (empty on other ranks), the
    densify counts (sharded, single), the capacity after each densify
    and the kernel launches (cuda_lib.LAUNCHES) of the sharded steps
    alone."""
    k = cfg.n_offsets
    sh = ShardedTrajectory(mesh, cfg, params, active, backend, device)
    full = sh.full()  # a collective: every rank takes part
    sd: Optional[SingleTrajectory] = (
        SingleTrajectory(cfg, full, backend, device, mesh.n_view)
        if dist.get_rank() == 0 else None)
    out: Dict[str, Any] = {"losses_sharded": [], "losses_single": [],
                            "densify": [], "capacity": []}
    launches: collections.Counter = collections.Counter()
    for it in range(1, steps + 1):
        before = collections.Counter(cuda_lib.LAUNCHES)
        loss = sh.step(contractor, cams[mesh.view], gts[mesh.view])[3]["loss"]
        launches.update(cuda_lib.LAUNCHES - before)
        out["losses_sharded"].append(float(loss))
        if sd is not None:
            out["losses_single"].append(float(
                sd.step(contractor, cams, gts)[3]["loss"]))
        if it in densify_at:
            full, counts = densify(sh.full(), it, k, voxel_size)
            if sd is not None:
                _, counts_sd = densify((sd.params, sd.opt_state, sd.active,
                                        sd.stats), it, k, voxel_size)
                out["densify"].append([it, counts, counts_sd])
            if it == regrow_after:
                full = regrow(full, k)
            out["capacity"].append(full[0]["anchors"]["anchor"].shape[0])
            sh.place(*full)
            if sd is not None:  # the single trajectory adopts the state
                sd.params, sd.opt_state, sd.active, sd.stats = full
        if it == activate_at:
            for traj in (sh,) if sd is None else (sh, sd):
                traj.level += 1
                tx = make_optimizer(traj.opt, traj.params, 1.0, traj.level,
                                    device=device)
                traj.opt_state = tx.init(traj.params)
                traj.stats = _zero_stats(traj.stats)
                traj.build(tx)
    out["launches_sharded"] = dict(launches)
    return out


def untie_offsets(params, seed: int):
    """`params` with the anchors' offsets moved by a seeded normal draw of
    scale 0.05 (in units of the anchor's scaling).  The k gaussians of an
    anchor start at one point, at one depth, and the order of equal
    depths in a tile follows each gaussian's slot rank, which a strip's
    clamped rect changes; with distinct depths the strips reproduce the
    whole view's records."""
    anchors = params["anchors"]
    off = anchors["offsets"]
    draw = torch.randn(off.shape, generator=torch.Generator().manual_seed(
        seed)).to(off.device)
    return dict(params, anchors=dict(anchors, offsets=off + 0.05 * draw))


# an optimizer whose update is the reduced gradient itself, so a step's
# new params are its gradient.  Adam's first update, about lr * sign(g),
# would hide the gradient's size and turn a gradient at rounding level
# into a difference of 2 lr.
GRADIENT = Optimizer(
    init=lambda p: {m: tree_map(torch.zeros_like, p) for m in ("mu", "nu")},
    update=lambda g, state, p: (g, state))


def step_gradients(mesh: Mesh, cfg: ModelConfig, params, active, contractor,
                   cam, gt, backend: str, device, terms=TERMS):
    """One sharded step's gradient from `params` (full, replicated on
    every rank): returns (the full gradient tree, gathered over gauss,
    the full statistics, the metrics)."""
    stats = init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                       device=device)
    p, o, a, st = shard_params(mesh, params, GRADIENT.init(params), active,
                               stats)
    fn = make_sharded_train_step(cfg, OptimizationConfig(), mesh, GRADIENT,
                                 backend=backend, q_noise=0.0, device=device)
    grads, _, new_st, metrics = fn(p, o, a, contractor, st, cam, gt, 0,
                                   *terms)
    grads = dict(grads, anchors=tree_map(lambda x: gather_rows(mesh, x),
                                         grads["anchors"]))
    return (grads, TrainStats(**{f: gather_rows(mesh, getattr(new_st, f))
                                 for f in STAT_FIELDS}), metrics)


def single_gradients(cfg: ModelConfig, params, active, contractor, cams,
                     gts, backend: str, device, terms=TERMS):
    """The single-device step's gradient on the views `cams` / `gts`
    (mv = len(cams)), from the same state as step_gradients: (gradient
    tree, statistics, metrics)."""
    fn = make_train_step(cfg, OptimizationConfig(), len(cams), 0, GRADIENT,
                         q_noise=0.0, device=device, backend=backend)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    grads, _, stats, metrics = fn(
        params, GRADIENT.init(params), active, contractor,
        init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                   device=device), list(cams), list(gts), bg, None, 0,
        *terms)
    return grads, stats, metrics
