"""Training driver (counterpart of splatco_tpu/train/loop.py): host-side
orchestration around the SVC step.

Camera sampling (pop from a shuffled stack, the batch sorted by
resolution), the phase switches, the cached consistency gates, CVPM pair
pruning and the densification cadence, graph downsampling, plane-level
activation (an optimizer rebuild with the schedules fast-forwarded),
capacity regrowth, kmax auto-escalation, eval, model saves and full-state
checkpoints for exact resume.

The port has no static slot budgets (`kmax_pack`, `class_spec`): its
binning sizes itself per frame.  What remains of the JAX controller is
kmax's escalation when tile rects clip, up to `kmax_cap`, and a once-only
warning at the cap.  The escalated kmax is part of the training state
(`chkpnt<N>.json`'s "kmax"), so a resumed run clips as the straight one.

Randomness: `random.Random(seed)` samples the cameras, as in the JAX
trainer; one torch.Generator on the device draws the quantization noise
and the densify and graph-downsample draws.  Both states are saved with
a training checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig, save_run_config)
from splatco_torch.data.scene import Scene
from splatco_torch.models.anchors import grow_capacity, pad_rows
from splatco_torch.models.contraction import Contractor, make_contractor
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops.losses import l1_loss, psnr, ssim
from splatco_torch.train import checkpoint as ckpt
from splatco_torch.train.cvpm import curvature_offset_mask, cvpm_pair_mask
from splatco_torch.train.densify import adjust_anchor, graph_downsample
from splatco_torch.train.optimizer import make_optimizer, tree_map
from splatco_torch.train.step import TrainStats, init_stats, make_train_step
from splatco_torch.utils.device import resolve_device

STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")


def _eval_view_metrics(img, gt):
    """L1, mean PSNR and SSIM of one view, as device scalars."""
    return torch.stack([l1_loss(img, gt), psnr(img, gt).mean(),
                        ssim(img, gt)])


class ViewerSnapshot(NamedTuple):
    """What a viewer renders: the trainer's state after an iteration's
    host logic, published as one tuple so a reader on another thread
    never pairs the params of one capacity with the mask of another."""
    iteration: int
    params: Dict[str, Any]
    active: torch.Tensor
    contractor: Contractor
    activate_level: int
    kmax: int
    bg: torch.Tensor


def get_logger(path: str) -> logging.Logger:
    logger = logging.getLogger("splatco_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    os.makedirs(path, exist_ok=True)
    fh = logging.FileHandler(os.path.join(path, "outputs.log"))
    sh = logging.StreamHandler()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s: %(message)s")
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def _fast_forward_schedules(opt_state, iteration: int):
    """After an optimizer rebuild, restore the global step for the LR
    schedules (the reference's schedules key on the global iteration);
    Adam's own counts restart."""
    return dict(opt_state, sched_count={
        g: torch.full_like(c, iteration)
        for g, c in opt_state["sched_count"].items()})


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    opt: OptimizationConfig
    pipe: PipelineConfig
    logger: Optional[logging.Logger] = None
    test_iterations: tuple = (3000, 7000, 12000, 17000, 22000, 30000)
    save_iterations: tuple = (7000, 30000)
    checkpoint_iterations: tuple = (7000, 30000)
    no_multilevel: bool = False
    no_regularization: bool = False
    # ablation switches: the SVC pairwise consistency loss and the CVPM
    # cross-view prune
    no_consistency: bool = False
    no_cvpm: bool = False
    metrics_log: Optional[list] = None
    # plane-pyramid activation schedule (reference train.py:305-307)
    activation_iterations: tuple = (12000, 21000)
    # warn once when this many gaussians per step render with clipped tile
    # rects at kmax_cap
    clip_warn_threshold: int = 1000
    # double kmax (up to kmax_cap) when any gaussian's tile rect clips, so
    # steady-state renders are exact
    auto_kmax_escalate: bool = True
    kmax_cap: int = 32
    # run the step twice from identical inputs every `determinism_every`
    # steps and require bit-identical params and metrics
    determinism_check: bool = False
    determinism_every: int = 100
    # mirror the TensorBoard scalars to wandb, where installed
    use_wandb: bool = False
    device: Any = None          # None: the card
    # "cuda": the tile kernels; "dense": the dense compositor
    backend: str = "cuda"
    # optional viewer/network_gui.ViewerServer: its `train` control field
    # pauses and resumes the loop, its `keep_alive` holds it at the end
    viewer: Optional[Any] = None

    def setup(self, scene: Scene, seed: int = 0):
        self.dev = resolve_device(self.device)
        self.scene = scene
        self.logger = self.logger or get_logger(self.cfg.model_path or ".")
        if self.cfg.contractor:
            center, length = scene.scene_bbox()
            self.cfg.scene_center = center
            self.cfg.scene_length = length
        # own RNG instance (not the global `random`) so camera sampling is
        # part of the checkpointable state
        self.py_rng = random.Random(seed)
        self.generator = torch.Generator(device=self.dev).manual_seed(seed)
        self.start_iter = 0
        num_cameras = (len(scene.train_cameras())
                       + len(scene.test_cameras()))
        self.params, self.mstate = init_model(
            self.cfg, scene.points,
            generator=torch.Generator().manual_seed(seed),
            num_cameras=num_cameras, device=self.dev)
        self.spatial_lr_scale = scene.cameras_extent
        self.activate_level = 0
        self._rebuild_optimizer(iteration=0)
        self.stats = init_stats(self.params["anchors"]["anchor"].shape[0],
                                self.cfg.n_offsets, device=self.dev)
        self.viewpoint_stack: List[int] = []
        self._gate_cache: Dict[Any, float] = {}
        self._clip_warned = False
        self.train_cams = scene.train_cameras()
        self.published: Optional[ViewerSnapshot] = None
        self.metrics_log = []
        self.ema_loss = 0.0
        self.tb_writer = None
        self.wandb = None
        if self.use_wandb:
            try:
                import wandb

                wandb.init(project="splatco_torch",
                           name=os.path.basename(self.cfg.model_path
                                                 or "run"),
                           config=dataclasses.asdict(self.cfg))
                self.wandb = wandb
            except ImportError:
                self.logger.info("wandb not available: not logging to it")
        if self.cfg.model_path:
            save_run_config(self.cfg.model_path, self.cfg, self.pipe,
                            self.opt)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(self.cfg.model_path)
            except ImportError:
                self.logger.info("Tensorboard not available: not logging "
                                 "progress")

    # ------------------------------------------------------------------
    def _rebuild_optimizer(self, iteration: int):
        self.tx = make_optimizer(self.opt, self.params,
                                 self.spatial_lr_scale, self.activate_level,
                                 device=self.dev)
        self.opt_state = _fast_forward_schedules(self.tx.init(self.params),
                                                 iteration)
        self._step_cache: Dict[Any, Any] = {}

    def _get_step(self):
        """The step for the current level; it reads cfg.kmax per call."""
        if self.activate_level not in self._step_cache:
            self._step_cache[self.activate_level] = make_train_step(
                self.cfg, self.opt, self.pipe.mv, self.activate_level,
                self.tx, device=self.dev, backend=self.backend)
        return self._step_cache[self.activate_level]

    def _pair_gates(self, cams, gts) -> torch.Tensor:
        """SSIM gates of the i<j consistency pairs (reference
        train.py:215), cached by camera uid pair: a ground truth is fixed
        per camera for the Trainer's lifetime, so each pair costs one
        full-frame SSIM per run.  [n_pairs] float32 in row-major order."""
        mv = len(cams)
        pairs = [(i, j) for i in range(mv) for j in range(i + 1, mv)]
        missing = []
        for i, j in pairs:
            key = (cams[i].uid, cams[j].uid)
            if key not in self._gate_cache:
                mh = min(gts[i].shape[-2], gts[j].shape[-2])
                mw = min(gts[i].shape[-1], gts[j].shape[-1])
                missing.append((key, ssim(gts[i][..., :mh, :mw],
                                          gts[j][..., :mh, :mw])))
        if missing:
            vals = torch.stack([v for _, v in missing]).cpu().tolist()
            for (key, _), v in zip(missing, vals):
                self._gate_cache[key] = v
        return torch.tensor([self._gate_cache[(cams[i].uid, cams[j].uid)]
                             for i, j in pairs], dtype=torch.float32,
                            device=self.dev)

    def _escalate_kmax(self, num_clipped: int) -> None:
        """Treat clipped tile rects like the JAX trainer treats them: that
        step was approximate at the clipped fringes, so double kmax (up to
        kmax_cap) for the next steps; at the cap, warn once."""
        if num_clipped > 0 and self.auto_kmax_escalate and \
                self.cfg.kmax < self.kmax_cap:
            new_kmax = min(self.cfg.kmax * 2, self.kmax_cap)
            self.logger.info(
                f"kmax: {num_clipped} gaussians clipped at kmax="
                f"{self.cfg.kmax} -> escalating to {new_kmax}")
            self.cfg.kmax = new_kmax
            return
        if num_clipped > self.clip_warn_threshold and not self._clip_warned:
            self._clip_warned = True
            self.logger.warning(
                f"{num_clipped} gaussians/step have tile rects clipped to "
                f"kmax={self.cfg.kmax} — the image is approximate at their "
                "fringes; consider a larger --kmax")

    def _check_step_determinism(self, step, step_args, it: int) -> None:
        """Run the step twice from identical inputs (and generator state)
        and require bit-identical params and metrics.  The generator is
        left as it was, so the real step draws the same noise."""
        state = self.generator.get_state()
        outs = []
        for _ in range(2):
            self.generator.set_state(state)
            outs.append(step(*step_args))
        self.generator.set_state(state)
        (p1, _, _, m1), (p2, _, _, m2) = outs
        p1, p2 = ckpt.params_to_numpy(p1), ckpt.params_to_numpy(p2)
        bad = [key for key in p1
               if not np.array_equal(p1[key], p2[key], equal_nan=True)]
        bad += [f"metrics[{n}]" for n in ("loss", "l1")
                if not torch.equal(m1[n], m2[n])]
        if bad:
            raise RuntimeError(
                f"[ITER {it}] determinism check FAILED — double-run "
                f"mismatch in: {', '.join(bad)}")
        self.logger.info(f"[ITER {it}] determinism check ok")

    def _sample_cameras(self):
        cams = []
        for _ in range(self.pipe.mv):
            if not self.viewpoint_stack:
                self.viewpoint_stack = list(range(len(self.train_cams)))
            idx = self.viewpoint_stack.pop(
                self.py_rng.randint(0, len(self.viewpoint_stack) - 1))
            cams.append(self.train_cams[idx])
        # the batch sorted by resolution, as the JAX trainer sorts it
        cams.sort(key=lambda c: (c.image_height, c.image_width))
        return cams

    def publish(self, iteration: Optional[int] = None):
        """Publish the state a viewer renders.  The step, the optimizer,
        densify and regrowth return new tensors and never write into the
        ones they are given, so the published tensors stay as they were
        when published."""
        self.published = ViewerSnapshot(
            iteration=self.start_iter if iteration is None else iteration,
            params=self.params, active=self.mstate.active,
            contractor=self.mstate.contractor,
            activate_level=self.activate_level, kmax=self.cfg.kmax,
            bg=self._bg())

    def _bg(self):
        bg = [1.0, 1.0, 1.0] if self.cfg.white_background else [0, 0, 0]
        return torch.tensor(bg, dtype=torch.float32, device=self.dev)

    def _flush_metrics(self):
        """Fetch the deferred per-step metrics in one transfer, update the
        EMA loss and escalate kmax from the last step's clip count.
        Returns the last step's loss."""
        if not self._pending:
            return None
        stacked = torch.stack([
            torch.stack([m["loss"].double(), m["l1"].double(),
                         m["num_clipped"].double()])
            for _, m in self._pending]).cpu().numpy()
        for lv in stacked[:, 0]:
            self.ema_loss = 0.4 * float(lv) + 0.6 * self.ema_loss
        self._escalate_kmax(int(stacked[-1, 2]))
        self._last_l1 = float(stacked[-1, 1])
        self._pending.clear()
        return float(stacked[-1, 0])

    # ------------------------------------------------------------------
    def train(self, iterations: Optional[int] = None,
              progress_every: int = 100):
        opt = self.opt
        iterations = iterations or opt.iterations
        bg = self._bg()
        log = self.logger
        self._pending: List = []
        self._last_l1 = 0.0
        t_window = time.perf_counter()
        window_n = 0
        if self.viewer is not None:
            self.publish()
        for it in range(self.start_iter + 1, iterations + 1):
            if self.viewer is not None:
                self.viewer.wait_training_allowed()
            cams = self._sample_cameras()
            gts = [c.image for c in cams]
            in_update = opt.update_from < it < opt.update_until
            consistency_on = float(in_update and not self.no_consistency)
            tv_w = (opt.tv_weight_a
                    if it % 4 == 0 and not self.no_regularization else 0.0)
            stats_on = float(opt.start_stat < it < opt.update_until)

            step = self._get_step()
            step_args = (
                self.params, self.opt_state, self.mstate.active,
                self.mstate.contractor, self.stats, cams, gts, bg,
                self.generator, it, consistency_on, tv_w, stats_on,
                self._pair_gates(cams, gts))
            if (self.determinism_check
                    and it % self.determinism_every == 0):
                self._check_step_determinism(step, step_args, it)
            self.params, self.opt_state, self.stats, metrics = step(
                *step_args)
            self._pending.append((it, metrics))
            window_n += 1
            # fetch the metrics only where the host logic needs them
            need_host = (
                it % progress_every == 0
                or (in_update and it % opt.update_interval == 0)
                or it in opt.graph_downsampling_iters
                or it in self.activation_iterations
                or it in self.test_iterations
                or it in self.save_iterations
                or it in self.checkpoint_iterations
                or it == iterations or it == 1)
            loss = self._flush_metrics() if need_host else None
            dt = ((time.perf_counter() - t_window) / window_n
                  if need_host else None)
            if need_host:
                t_window = time.perf_counter()
                window_n = 0

            if it == 1 and not self.cfg.contractor:
                self._update_contractor()

            if in_update and it % opt.update_interval == 0:
                self._cvpm_and_densify(it, cams, gts)

            if it in opt.graph_downsampling_iters:
                self._graph_downsample(it)

            if it in self.activation_iterations and not self.no_multilevel:
                self.activate_level += 1
                log.info(f"[ITER {it}] plane level -> "
                         f"{self.activate_level}")
                self._rebuild_optimizer(iteration=it)
                self.stats = init_stats(
                    self.params["anchors"]["anchor"].shape[0],
                    self.cfg.n_offsets, device=self.dev)

            if it % progress_every == 0:
                self._log_progress(it, loss, dt)
            if it in self.test_iterations:
                self.evaluate(it)
            if it in self.save_iterations and self.cfg.model_path:
                log.info(f"[ITER {it}] saving model")
                self.save_model(it)
            if it in self.checkpoint_iterations and self.cfg.model_path:
                log.info(f"[ITER {it}] saving training checkpoint")
                self.save_training_state(it)
            if self.viewer is not None:
                self.publish(it)
        if self.viewer is not None:
            self.viewer.wait_released()
        return self.metrics_log

    def _update_contractor(self):
        """The reference's update_contractor (train.py:298-303), working:
        the bbox of the active anchors, length * 1.1, contraction off."""
        pts = self.params["anchors"]["anchor"][self.mstate.active]
        if not len(pts):
            return
        pts = pts.cpu().numpy()
        center = pts.mean(axis=0).tolist()
        length = ((pts.max(axis=0) - pts.min(axis=0)) * 1.1).tolist()
        self.mstate = dataclasses.replace(
            self.mstate, contractor=make_contractor(
                center, length, self.cfg.bbox_scale, enabled=False,
                device=self.dev))
        self.logger.info(f"update_contractor: center {center} "
                         f"length {length}")

    def _graph_downsample(self, it: int):
        c = self.mstate.active.shape[0]
        scores = torch.rand(c, generator=self.generator, device=self.dev)
        (self.params, self.opt_state, active, self.stats,
         n_left) = graph_downsample(
            self.params, self.opt_state, self.mstate.active, self.stats,
            scores, self.opt.pc_downsamplerate)
        self.mstate = dataclasses.replace(self.mstate, active=active)
        self.opt.densify_grad_threshold *= 1.2
        self.logger.info(f"[ITER {it}] graph downsample -> {int(n_left)} "
                         "anchors")

    def _log_progress(self, it: int, loss: float, dt: float):
        n_act = int(self.mstate.active.sum())
        self.logger.info(f"[ITER {it}] loss {self.ema_loss:.5f} "
                         f"anchors {n_act} step_ms {dt * 1e3:.0f}")
        self.metrics_log.append(
            {"iteration": it, "loss": loss, "ema_loss": self.ema_loss,
             "anchors": n_act, "step_ms": dt * 1e3})
        scalars = {"total_loss": loss, "l1_loss": self._last_l1,
                   "iter_time": dt * 1e3, "total_points": n_act}
        if self.tb_writer is not None:
            self.tb_writer.add_scalar("train_loss_patches/total_loss", loss,
                                      it)
            self.tb_writer.add_scalar("train_loss_patches/l1_loss",
                                      self._last_l1, it)
            self.tb_writer.add_scalar("iter_time", dt * 1e3, it)
            self.tb_writer.add_scalar("total_points", n_act, it)
        if self.wandb is not None:
            self.wandb.log(scalars, step=it)

    # ------------------------------------------------------------------
    def _contractor_meta(self) -> dict:
        c = self.mstate.contractor
        return {"contractor_min": c.xyz_min.cpu().tolist(),
                "contractor_max": c.xyz_max.cpu().tolist(),
                "contractor_enabled": bool(c.enabled)}

    def save_model(self, it: int) -> None:
        """point_cloud/iteration_<it>/, readable by both packages."""
        ckpt.save_model_checkpoint(
            self.cfg.model_path, it, self.params, self.mstate.active,
            meta={"iteration": it, "activate_level": self.activate_level,
                  "voxel_size": self.mstate.voxel_size,
                  "spatial_lr_scale": self.spatial_lr_scale,
                  **self._contractor_meta()})

    def _state_tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "stats": {f: getattr(self.stats, f) for f in STAT_FIELDS},
                "active": self.mstate.active,
                "key": self.generator.get_state()}

    def save_training_state(self, iteration: int) -> None:
        """Everything a resumed run needs to continue bit for bit: the
        tree (params, optimizer state, statistics, active mask, the
        generator's state where the JAX trainer keeps its key) and the
        JAX trainer's scalar meta, plus the escalated kmax.  The JAX
        slot-budget keys are written as null (kp_floor 1)."""
        st = self.py_rng.getstate()
        meta = {
            "iteration": iteration,
            "activate_level": self.activate_level,
            "capacity": int(self.params["anchors"]["anchor"].shape[0]),
            "kmax_pack": None,
            "kp_floor": 1,
            "class_spec": None,
            "kmax": self.cfg.kmax,
            "ema_loss": self.ema_loss,
            "voxel_size": self.mstate.voxel_size,
            "spatial_lr_scale": self.spatial_lr_scale,
            "densify_grad_threshold": self.opt.densify_grad_threshold,
            "viewpoint_stack": self.viewpoint_stack,
            "py_rng_state": [st[0], list(st[1]), st[2]],
            **self._contractor_meta(),
        }
        ckpt.save_train_state(self.cfg.model_path, iteration,
                              self._state_tree(), meta)

    def restore(self, iteration: int = -1) -> int:
        """Resume from a chkpnt<iteration> full-state checkpoint (-1: the
        latest).  Call after setup(); returns the restored iteration, and
        train() continues from the next step bit for bit."""
        if iteration == -1:
            iteration = ckpt.latest_train_checkpoint(self.cfg.model_path)
            if iteration is None:
                raise FileNotFoundError(
                    f"no training checkpoints in {self.cfg.model_path}")
        tree, meta = ckpt.load_train_state(self.cfg.model_path, iteration,
                                           device=self.dev)
        self.activate_level = int(meta["activate_level"])
        self.spatial_lr_scale = float(meta["spatial_lr_scale"])
        self.params = tree["params"]
        self.tx = make_optimizer(self.opt, self.params,
                                 self.spatial_lr_scale, self.activate_level,
                                 device=self.dev)
        self._step_cache = {}
        self.opt_state = tree["opt_state"]
        self.stats = TrainStats(**tree["stats"])
        self.generator.set_state(tree["key"].cpu())
        self.mstate = dataclasses.replace(
            self.mstate,
            active=tree["active"],
            voxel_size=float(meta["voxel_size"]),
            contractor=Contractor(
                xyz_min=torch.tensor(meta["contractor_min"],
                                     dtype=torch.float32, device=self.dev),
                xyz_max=torch.tensor(meta["contractor_max"],
                                     dtype=torch.float32, device=self.dev),
                enabled=bool(meta["contractor_enabled"])))
        self.opt.densify_grad_threshold = float(
            meta["densify_grad_threshold"])
        self.cfg.kmax = int(meta.get("kmax", self.cfg.kmax))
        self.ema_loss = float(meta["ema_loss"])
        self.viewpoint_stack = [int(i) for i in meta["viewpoint_stack"]]
        st = meta["py_rng_state"]
        self.py_rng.setstate((st[0], tuple(st[1]), st[2]))
        self.start_iter = int(meta["iteration"])
        self.logger.info(f"restored training state from iteration "
                         f"{self.start_iter}")
        return self.start_iter

    # ------------------------------------------------------------------
    def _cvpm_and_densify(self, it: int, cams, gts):
        opt = self.opt
        anchor = self.params["anchors"]["anchor"]
        c = anchor.shape[0]
        k = self.cfg.n_offsets

        # CVPM: the pairwise geometric-consistency prune (reference
        # train.py:220-236), gated on the ground-truth pair's SSIM > 0.6
        cvpm = torch.zeros(c, dtype=torch.bool, device=self.dev)
        mv = len(cams)
        if not self.no_cvpm:
            gates = self._pair_gates(cams, gts).cpu().tolist()
            pairs = [(i, j) for i in range(mv) for j in range(i + 1, mv)]
            for (i, j), gate in zip(pairs, gates):
                if gate <= 0.6:
                    continue
                if self.cfg.cvpm_compat_T:  # the as-shipped T-vector quirk
                    o1, o2 = cams[i].T, cams[j].T
                else:
                    o1, o2 = cams[i].camera_center, cams[j].camera_center
                cvpm = cvpm | cvpm_pair_mask(
                    anchor, self.mstate.active, o1, o2,
                    distance_threshold=self.mstate.voxel_size)

        # camera-baseline-adaptive threshold (train.py:270-281)
        centers = [cam.camera_center.cpu().numpy() for cam in cams]
        centers = [cc / max(np.linalg.norm(cc), 1e-12) for cc in centers]
        diffs = [np.linalg.norm(centers[i] - centers[j])
                 for i in range(mv) for j in range(i + 1, mv)]
        densify_t = (opt.densify_grad_threshold * 0.5
                     if any(d > 1 for d in diffs)
                     else opt.densify_grad_threshold)

        # curvature densification (gaussian_model.py:938-947)
        if it == 1600 or it % 3000 == 0:
            extra = curvature_offset_mask(anchor, self.mstate.active, k)
        else:
            extra = torch.zeros(c * k, dtype=torch.bool, device=self.dev)

        draws = torch.rand((self.cfg.update_depth, c * k),
                           generator=self.generator, device=self.dev)
        res = adjust_anchor(
            self.params, self.opt_state, self.mstate.active, self.stats,
            draws, self.mstate.voxel_size, densify_t, extra, cvpm,
            check_interval=opt.update_interval,
            success_threshold=opt.success_threshold,
            min_opacity=opt.min_opacity,
            update_depth=self.cfg.update_depth,
            update_init_factor=self.cfg.update_init_factor,
            update_hierachy_factor=self.cfg.update_hierachy_factor)
        self.params = res.params
        self.opt_state = res.opt_state
        self.stats = res.stats
        self.mstate = dataclasses.replace(self.mstate, active=res.active)

        # the densify event, recorded in the trajectory
        grown, pruned, dropped, n_act, cvpm_marked = torch.stack([
            res.num_grown, res.num_pruned, res.num_dropped, res.num_active,
            cvpm.sum()]).cpu().tolist()
        regrew = int(dropped > 0 or n_act > 0.9 * c)
        self.metrics_log.append(
            {"iteration": it, "densify_grown": grown,
             "densify_pruned": pruned, "densify_dropped": dropped,
             "cvpm_marked": cvpm_marked, "anchors_after": n_act,
             "capacity_regrow": regrew})
        if grown or pruned or cvpm_marked:
            self.logger.info(
                f"[ITER {it}] densify: +{grown} -{pruned} "
                f"(cvpm marked {cvpm_marked}, dropped {dropped}) "
                f"-> {n_act} anchors")
        # capacity regrowth when the padded buffers run out
        if regrew:
            self._grow(int(c * 2))

    def _grow(self, new_capacity: int):
        """Re-pad the anchors, their statistics and their Adam moments to
        `new_capacity` (capped at cfg.max_capacity): old rows, moments
        and counts are kept, new rows are zero (the reference's
        cat_tensors_to_optimizer semantics)."""
        cap = self.cfg.max_capacity
        if cap:
            new_capacity = min(new_capacity, cap)
        c = self.params["anchors"]["anchor"].shape[0]
        if new_capacity <= c:
            self.logger.info(
                f"capacity regrowth capped at {c} (max_capacity {cap}): "
                "further growth candidates will be dropped")
            return
        self.logger.info(f"growing anchor capacity -> {new_capacity}")
        anchors, active = grow_capacity(self.params["anchors"],
                                        self.mstate.active, new_capacity)
        self.params = dict(self.params, anchors=anchors)
        self.mstate = dataclasses.replace(self.mstate, active=active)
        k = self.cfg.n_offsets
        self.stats = TrainStats(**{
            f: pad_rows(getattr(self.stats, f),
                         new_capacity * (k if f.startswith("offset") else 1))
            for f in STAT_FIELDS})
        self.opt_state = dict(self.opt_state, **{
            m: dict(self.opt_state[m], anchors=tree_map(
                lambda a: pad_rows(a, new_capacity),
                self.opt_state[m]["anchors"]))
            for m in ("mu", "nu")})

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, it: int, max_views: Optional[int] = None,
                 tb_images: int = 5):
        """In-training eval (the reference's training_report): the full
        test split and 5 fixed train views, L1 / PSNR / SSIM, and the
        first test renders (plus the ground truths once) to TensorBoard."""
        bg = self._bg()
        dkw = decode_kwargs(self.cfg)
        test_cams = self.scene.test_cameras()
        if max_views is not None:
            test_cams = test_cams[:max_views]
        for name, cams in (("test", test_cams),
                           ("train", self.train_cams[5:30:5])):
            if not cams:
                continue
            dev_metrics, tb_imgs, tb_gts = [], [], []
            for vi, cam in enumerate(cams):
                vis = prefilter_voxel(self.params["anchors"],
                                      self.mstate.active, cam)
                out = render(
                    self.params, self.mstate.active,
                    self.mstate.contractor, cam, bg, visible_mask=vis,
                    activate_level=self.activate_level, is_training=False,
                    kmax=self.cfg.kmax, backend=self.backend, **dkw)
                img = torch.clamp(out.image, 0.0, 1.0)
                gt = torch.clamp(cam.image, 0.0, 1.0)
                dev_metrics.append(_eval_view_metrics(img, gt))
                if self.tb_writer is not None and vi < tb_images:
                    tb_imgs.append(img)
                    if (not self.test_iterations
                            or it == self.test_iterations[0]):
                        tb_gts.append((vi, gt))  # static: logged once
            fetched = torch.stack(dev_metrics).cpu().numpy()  # [V, 3]
            l1, ps, ss = (float(v) for v in fetched.mean(axis=0))
            for vi, img in enumerate(tb_imgs):
                self.tb_writer.add_image(f"{name}_view_{vi}/render",
                                         img.cpu().numpy(), it)
            for vi, gt in tb_gts:
                self.tb_writer.add_image(f"{name}_view_{vi}/ground_truth",
                                         gt.cpu().numpy(), it)
            self.logger.info(f"[ITER {it}] eval {name}: L1 {l1:.5f} "
                             f"PSNR {ps:.3f} SSIM {ss:.4f} "
                             f"({len(cams)} views)")
            self.metrics_log.append(
                {"iteration": it, f"{name}_l1": l1, f"{name}_psnr": ps,
                 f"{name}_ssim": ss})
            if self.wandb is not None:
                self.wandb.log({f"{name}_l1": l1, f"{name}_psnr": ps,
                                f"{name}_ssim": ss}, step=it)
            if self.tb_writer is not None:
                for metric, v in (("l1_loss", l1), ("psnr", ps),
                                  ("ssim", ss)):
                    self.tb_writer.add_scalar(
                        f"{name}/loss_viewpoint - {metric}", v, it)

