#!/usr/bin/env python3
"""Drive the splatco_torch render and training paths on one NVIDIA card, in
both rasterizer configurations (32 px tiles, v2; 16 px tiles, v3), and
hold each CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N] [--frames N] [--steps N]

Run from the repository root.  Phases, each of which fails loudly:
  1. the card's name and power limit (nvidia-smi),
  2. build every kernel under splatco_torch/csrc with nvcc for sm_90a,
  3. kernel checks: a random projected scene (~200k gaussians, 1600x1088)
     through the port's binning, then the CUDA blend kernel and the CUDA
     blend-backward kernel (seeded image cotangent) against their plain
     versions on the card; two backward launches must be bit-identical,
  4. render path at full width: the README quick-start model (feat_dim
     32, n_offsets 10, num_channels 15, plane_size 2800 -> plane levels
     [700, 700, 1400] with TPA on level 0, contractor, bbox_scale 0.3)
     with 65,536 anchors from a seeded normal cloud (655,360 gaussians),
     rendered at activate_level 2 from orbit cameras at 1600x1088 through
     `render_set`; the forward kernel's launch count must equal the
     frames,
  5. one frame's stages timed, and the forward kernel timed against its
     plain version at that frame's shapes, with its bound, the frame's
     records per tile and the share of (record, warp) pairs the kernel's
     per-warp cull skips,
  6. a small model rendered on the card and on the CPU must agree,
  7. training path at full width: the same model, mv = 4 orbit views at
     1600x1088 with smooth seeded target images, the port's
     `make_train_step` with the default OptimizationConfig and every loss
     term on: 1 warm-up and `--steps` timed steps at activate_level 0,
     one step timed stage by stage, then the optimizer rebuilt and 2
     steps at level 2.  Every loss must be finite, every trained leaf
     must move and stay finite, and each kernel must launch mv times per
     step,
  8. the forward kernel at a training view's shapes, against its plain
     version and timed beside its bound, and the backward kernel timed
     against its plain version at those shapes (with that view's loss
     cotangent), with its bound; the view's records per tile (max / p99 /
     mean) and the share of (record, warp) pairs each kernel's per-warp
     cull skips,
  9. determinism: two full-width steps from the same state must give
     bit-identical params, optimizer state and statistics,
 10. one step of a small model on the card and on the CPU: the losses
     must agree,
 11. v3 kernel checks: phase 3's scene binned on the 16 px grid (kmax
     32), the 16 px blend kernel and its backward against their plain
     versions; two backward launches must be bit-identical,
 12. v3 render at full width: the same model through
     `render_set(..., tile16=True)` with kmax 32; the 16 px forward
     kernel's launches must equal the frames and no other kernel may
     launch; one frame's stages, the kernel timed against its plain
     version, with its bound and the frame's records and cull share,
 13. v3 training at full width: phase 7 with `make_train_step(...,
     tile16=True)` and kmax 32: each 16 px kernel launches mv times per
     step and the 32 px kernels never; the 16 px kernels at a training
     view as in phase 8; two steps from one state bit-identical.
 14. the probes and the ablation: tools/micro_mosaic_torch.py and
     tools/profile_torch_kernel_v3.py driven through their `run`, with
     the launch counts of every probe mode and ablation variant exact;
     then each of those kernels against its plain version on the card
     (the row sums, the fp32 cumsum, the accumulation and the ablation's
     full / nostage / noaccum exactly or to the forward's bound; the
     TF32 cumsum against a float64 cumsum; the alpha-sum probe on the
     tool's inputs with row 2 made positive, since a negative row 2
     overflows exp), the plain versions and the one-call library
     versions (torch.cumsum, Tensor.add_) timed, and each kernel's bound.
 15. a scene on disk at full width: the port's `write_colmap_dataset`
     writes a COLMAP binary scene (16 views at 1600x1088, 65,536 points),
     `Scene` reads it onto the card (the ground-truth images must equal
     the written PNG pixels), the quick-start model is initialised from
     its points, saved with `save_model_checkpoint` / `save_run_config`,
     and `render_sets` renders it from disk: 14 train and 2 test PNGs,
     num_gaussians.json's anchors, the forward kernel launched once per
     frame, the loaded model's first test view equal to the in-memory
     model's render bit for bit; then `render_torch.py --skip_train` in a
     subprocess must write the same PNGs.  Prints the scene's load
     seconds, the native parser's points/s and render_sets' ms/frame.
 16. training from disk: `train_torch.main` (in this process, so its
     launches count) trains the quick-start model on phase 15's scene
     for 90 iterations (capacity 65,536, densify every 15 iterations in
     (10, 80), a graph downsample at 30, eval at 1 and 90, a training
     checkpoint at 45, the model saved at 90).  Every step's loss must be
     finite; there must be a densify call, a capacity regrowth 65,536 ->
     131,072 and one graph downsample; test PSNR must rise; the backward
     kernel must launch mv times a step and the forward mv times a step
     plus once an eval frame.  Step 70's first view (kmax 32, capacity
     131,072 on this scene) keeps its blend kernels' inputs: on them the
     forward kernel must equal its plain version bit for bit and the
     backward its plain version to 1e-5 of each row's max.  Prints
     ms/iteration over the run, the mean step (CUDA events, the first and
     the staged step apart), each densify, downsample, eval and save, and
     any kmax escalation.  A copy of the iteration-45 checkpoint is resumed
     by `train_torch.py --start_checkpoint` in a subprocess: its
     point_cloud/iteration_90 and its final training state (the active
     mask included) must equal the straight run's bit for bit.  Last,
     with the context grids (use_spatial_ctx) on, phase 7's trainer at
     level 2: two steps from one state must be bit-identical.
 17. evaluation of phase 16's trained model (iteration 90) through the
     entry points a user calls: `render_torch.main` renders its 14 train
     and 2 test views (the forward kernel launched once a view);
     `metrics_torch.main` scores the test views with LPIPS weights at
     VGG16's widths drawn from a seeded generator (results.json and
     per_view.json finite; each view's PSNR, SSIM, FLIP and LPIPS
     recomputed on the CPU from the same PNG pixels must agree: 1e-4 dB,
     1e-5, 1e-5, 1e-4 relative); each metric's ms per image on the card;
     16 orbit frames of the loaded model at 1600x1088 written as PNGs;
     `detect_popping_torch.main --flow raft` over them with seeded RAFT
     weights saved in the official checkpoint layout, 20 iterations,
     steps 1 and 7 (15 and 9 frame pairs, every aggregate finite, every
     valid_frac in [0, 1]), with the ms per RAFT flow and the peak
     device memory; RAFT on one orbit pair cropped to 400x544, 2
     iterations, card against CPU within 2e-3 x max(|flow|, 1).
Kernel times are splatco_torch.utils.measure.cuda_time_ms's.
Prints a `kernels` JSON line (all nine kernels), then, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero and prints no result when
there is no CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import zlib
from pathlib import Path

import numpy as np
import torch

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig, load_run_config,
                                  save_run_config)
from splatco_torch.data import native_io
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.images import save_png
from splatco_torch.data.scene import Scene
from splatco_torch.eval import metrics_driver, popping, raft
from splatco_torch.eval.render_driver import (load_trained, render_set,
                                              render_sets)
from splatco_torch.models.renderer import (generate_neural_gaussians,
                                           prefilter_voxel, render)
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops import (cuda_lib, lpips, probes, raster_ablate,
                               raster_v3)
from splatco_torch.ops import rasterize as rasterize_ops
from splatco_torch.ops.binning import TILE
from splatco_torch.ops.flip import ldr_flip
from splatco_torch.ops.losses import l1_loss, psnr, ssim
from splatco_torch.ops.projection import ProjectedCols, project_gaussians_cols
from splatco_torch.ops.rasterize import TILE16_DEFAULT, bin_frame, tile_grid
from splatco_torch.ops.rasterize_cuda import (BWD_KERNEL, BWD_KERNELS,
                                              FWD_KERNELS, KERNEL,
                                              bwd_cull_mask, fwd_cull_mask,
                                              raster_bwd, raster_bwd_plain,
                                              raster_fwd, raster_fwd_plain)
from splatco_torch.train import loop as train_loop
from splatco_torch.train.checkpoint import (params_to_numpy,
                                            save_model_checkpoint)
from splatco_torch.train.optimizer import (group_schedules, label_params,
                                           make_optimizer)
from splatco_torch.train.step import init_stats, make_train_step
from splatco_torch.utils.math import round_up
from splatco_torch.utils.measure import (PEAK_FP32_PER_S, PEAK_TF32_PER_S,
                                         bound, bwd_bound, cuda_time_ms,
                                         fwd_bound)
from splatco_torch.utils.synthetic import orbit_camera, write_colmap_dataset

# the forward kernels repeat their plain versions' float32 operations in
# the same order (built with --fmad=false; a record a warp culls changes
# nothing) and both use CUDA's expf: held to them bit for bit.  The
# ablation's variants are held to the bound the CPU tests use against JAX
RASTER_TOL = 1e-5
# the backward's per-record sums over a tile's 1024 pixels are taken in
# another order than the plain version's, so each of its nine rows is held
# to this share of the row's largest |value|
RASTER_BWD_TOL = 1e-5
WIDTH, HEIGHT = 1600, 1088
MV = PipelineConfig().mv  # views per training step: 4
TERMS = dict(consistency_on=1.0, tv_w=4e-7, stats_on=1.0)
# v3's kmax counts 16 px tiles: the JAX trainer's kmax_cap
# (splatco_tpu/train/loop.py), which its auto-escalation reaches once rects
# clip
KMAX_V3 = 32
KERNEL16 = FWD_KERNELS[raster_v3.TILE]
BWD_KERNEL16 = BWD_KERNELS[raster_v3.TILE]
# each kernel's C entry point and the TPU kernel it replaces
REPLACES = {
    KERNEL: "splatco_tpu/ops/rasterize_pallas.py:182",
    BWD_KERNEL: "splatco_tpu/ops/rasterize_pallas.py:241",
    KERNEL16: "splatco_tpu/ops/raster_v3.py:420",
    BWD_KERNEL16: "splatco_tpu/ops/raster_v3.py:467",
    probes.EXTRACT: "tools/micro_mosaic.py:64",
    probes.CUMSUM: "tools/micro_mosaic.py:88",
    probes.ACCUM: "tools/micro_mosaic.py:140",
    probes.BLEND: "tools/micro_mosaic.py:171",
    raster_ablate.KERNEL: "tools/profile_kernel_v3.py:61",
}
# phase 14: the tools time each probe mode and ablation variant over this
# many launches, after one checked launch and a warm-up
PROBE_ITERS = 20
# the fp32 cumsum adds in the plain version's order: held to 1e-6 of the
# max |value|; the TF32 one rounds each input to 10 mantissa bits and sums
# on the tensor cores, held to 5e-4 of the max of a float64 cumsum: above
# TF32's measured 1.9e-4, below the ~1.5e-3 of inputs rounded to bf16
CUMSUM_FP32_TOL = 1e-6
CUMSUM_TF32_TOL = 5e-4
# the alpha-sum probe repeats its plain version's float32 operations in
# order, up to the library exp: held to 1e-6 of the max |value|
BLEND_PROBE_TOL = 1e-6
# phase 15: the scene on disk (llffhold 8: views 0 and 8 are the test set)
DISK_VIEWS, DISK_POINTS, DISK_ITERATION = 16, 65536, 30000
# phase 16: train_torch.py on that scene, the README's quick-start flags
# with the capacity the scene fills (64,979 anchors of 65,536), a densify
# window, one graph downsample, eval at iterations 1 and 90, a training
# checkpoint at 45 (resumed in a subprocess) and the model saved at 90
TRAIN_ITERS, TRAIN_CKPT = 90, 45
TRAIN_STAGED = 70  # the step timed stage by stage (capacity 131,072)
TRAIN_ARGS = ["--mv", str(MV), "--num_channels", "15", "--plane_size", "2800",
              "--contractor", "--bbox_scale", "0.3", "--voxel_size", "0.01",
              "--update_init_factor", "16", "--appearance_dim", "0",
              "--capacity", str(DISK_POINTS), "--eval",
              "--iterations", str(TRAIN_ITERS), "--start_stat", "2",
              "--update_from", "10", "--update_interval", "15",
              "--update_until", "80", "--graph_downsampling_iters", "30",
              "--test_iterations", "1", str(TRAIN_ITERS),
              "--save_iterations", str(TRAIN_ITERS)]
# phase 17: evaluation of phase 16's model.  Card against CPU on the same
# PNG pixels: the same float32 operations summed in other orders
METRIC_TOL = {"PSNR": 1e-4, "SSIM": 1e-5, "FLIP": 1e-5}  # absolute
LPIPS_RTOL = 1e-4
ORBIT_FRAMES, POPPING_STEPS, RAFT_ITERS = 16, (1, 7), 20
# RAFT card against CPU on one orbit pair cropped to this size, few
# iterations: the recurrence carries the differences on
RAFT_CROP, RAFT_CHECK_ITERS, RAFT_TOL = (400, 544), 2, 2e-3


def random_projected_scene(n: int, seed: int, dev: torch.device):
    """Projected gaussians spread over a WIDTH x HEIGHT image: sigmas of
    0.5-12 px, random orientation, 5% culled."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    sx, sy, th = u(0.5, 12.0), u(0.5, 12.0), u(0.0, math.pi)
    c, s = torch.cos(th), torch.sin(th)
    a = c * c * sx * sx + s * s * sy * sy + 0.3
    b = c * s * (sx * sx - sy * sy)
    d = s * s * sx * sx + c * c * sy * sy + 0.3
    det = a * d - b * b
    mid = 0.5 * (a + d)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    radius = torch.where(torch.rand(n, generator=g) < 0.05, 0.0, radius)
    proj = ProjectedCols(mx=u(-40.0, WIDTH + 40.0), my=u(-40.0, HEIGHT + 40.0),
                         depth=u(1.0, 10.0), ca=d / det, cb=-b / det,
                         cc=a / det, radius=radius)
    colors = torch.rand((n, 3), generator=g)
    opac = u(0.05, 0.99)
    return (ProjectedCols(*(t.to(dev) for t in proj)), colors.to(dev),
            opac.to(dev))


def grid(tile16: bool):
    """(tiles_x, tiles_y) of the configuration at WIDTH x HEIGHT."""
    return (raster_v3.tile_grid if tile16 else tile_grid)(HEIGHT, WIDTH)


def tile_of(tile16: bool) -> int:
    return raster_v3.TILE if tile16 else TILE


def compare_kernel(binned, tiles_x, tiles_y, work=None, tile=TILE):
    """Max |kernel - plain| of rgb and of T on the same binned records."""
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, HEIGHT, WIDTH)
    rgb, t_fin = raster_fwd(*args, tile=tile)
    p_rgb, p_t = raster_fwd_plain(*args, work=work, tile=tile)
    torch.cuda.synchronize()
    return (float((rgb - p_rgb).abs().max()),
            float((t_fin - p_t).abs().max()))


def compare_bwd(binned, tiles_x, tiles_y, grad, rgb, t_fin, bg, work=None,
                tile=TILE):
    """Max |kernel - plain| of the backward on the same inputs, and the
    largest of the nine rows' max |d| over that row's max |value|.  Two
    kernel launches must agree bit for bit."""
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, HEIGHT, WIDTH, grad, rgb, t_fin, bg)
    got = raster_bwd(*args, tile=tile)
    again = raster_bwd(*args, tile=tile)
    want = raster_bwd_plain(*args, work=work, tile=tile)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"two {tile} px backward launches differ")
    diff = (got - want).abs()
    scale = want.abs().amax(dim=1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(dim=1) / scale).max())


def quickstart_config() -> ModelConfig:
    return ModelConfig(feat_dim=32, n_offsets=10, num_channels=15,
                       plane_size=2800, appearance_dim=0, contractor=True,
                       bbox_scale=0.3, voxel_size=0.01, capacity=65536,
                       scene_center=[0.0, 0.0, 0.0],
                       scene_length=[4.0, 4.0, 4.0], white_background=False)


def orbit_cameras(n: int, dev: torch.device):
    return [look_at_camera([3.5 * math.sin(2 * math.pi * i / n), 0.4,
                            -3.5 * math.cos(2 * math.pi * i / n)],
                           [0, 0, 0], [0, -1, 0], 1.2, 1.2 * HEIGHT / WIDTH,
                           WIDTH, HEIGHT, uid=i, device=dev)
            for i in range(n)]


def frame_stages(params, state, cam, cfg, level, tile16=False):
    """One frame's stages as render() runs them in the configuration, each
    timed with CUDA events (and named for torch.profiler); returns (binned
    records, {stage: ms})."""
    tiles_x, tiles_y = grid(tile16)
    marks = []

    @contextlib.contextmanager
    def stage(name):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.profiler.record_function(name):
            yield
        stop.record()
        marks.append((name, start, stop))

    with stage("prefilter"):
        vis = prefilter_voxel(params["anchors"], state.active, cam)
    with stage("decode"):
        g = generate_neural_gaussians(params, state.contractor, cam, vis,
                                      activate_level=level,
                                      **decode_kwargs(cfg))
    with stage("projection"):
        proj = project_gaussians_cols(g["xyz"], g["scaling"], g["rot"], cam)
        proj = proj._replace(radius=torch.where(g["opacity"] > 0.0,
                                                proj.radius, 0.0))
    with stage("binning"):
        binned = bin_frame(proj, g["color"], g["opacity"], tile_of(tile16),
                           HEIGHT, WIDTH, cfg.kmax)[0]
    with stage("blend"):
        raster_fwd(binned.records, binned.tile_start, binned.tile_end,
                   tiles_x, tiles_y, cam.image_height, cam.image_width,
                   tile=tile_of(tile16))
    marks[-1][2].synchronize()
    return binned, {name: a.elapsed_time(b) for name, a, b in marks}


def small_model_agrees(seed: int, dev: torch.device) -> float:
    """Max |card - CPU| of a small model's render; same seeded params on
    both.  exp and matmul sums differ between the two, so one alpha may
    land on the other side of the 1/255 cut: bound 4e-3 (= 1/255)."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0])
    pts = np.random.default_rng(seed).normal(size=(500, 3)).astype(
        np.float32) * 0.5
    images = []
    for d in (dev, torch.device("cpu")):
        params, state = init_model(cfg, pts, num_cameras=1, device=d,
                                   generator=torch.Generator().manual_seed(
                                       seed))
        cam = look_at_camera([0, 0, -3.0], [0, 0, 0], [0, -1, 0], 1.0,
                             0.75, 64, 48, device=d)
        with torch.inference_mode():
            vis = prefilter_voxel(params["anchors"], state.active, cam)
            out = render(params, state.active, state.contractor, cam,
                         torch.tensor([0.1, 0.2, 0.3], device=d),
                         visible_mask=vis, activate_level=2,
                         **decode_kwargs(cfg))
        images.append(out.image.cpu())
    diff = (images[0] - images[1]).abs()
    print(f"small model card vs CPU: max {float(diff.max()):.3e} "
          f"mean {float(diff.mean()):.3e}")
    if not float(diff.max()) <= 4e-3 or not float(diff.mean()) <= 1e-5:
        raise AssertionError("card and CPU renders disagree")
    return float(diff.max())


def flat(tree, prefix=""):
    """{path: tensor} of a nested dict/list tree, paths as the JAX
    package's keystr names them."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, val in items:
        out.update(flat(val, prefix + key))
    return out


def smooth_targets(n: int, seed: int, dev: torch.device):
    """n smooth target images [3, HEIGHT, WIDTH] in [0, 1] made by numpy
    from `seed`: four random low-frequency waves per channel shared by all
    views, plus one weak wave of each view's own, so that the views'
    pairwise SSIM passes the consistency term's 0.6 gate."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)

    def wave(amp):
        fx, fy = rng.uniform(-6.0, 6.0, 2) * 2 * math.pi / np.array(
            [WIDTH, HEIGHT])
        return np.float32(amp) * np.sin(
            np.float32(fx) * x + np.float32(fy) * y
            + np.float32(rng.uniform(0.0, 2 * math.pi)))

    base = np.stack([0.5 + sum(wave(rng.uniform(0.05, 0.15))
                               for _ in range(4)) for _ in range(3)])
    return [torch.as_tensor(np.clip(base + np.stack(
        [wave(0.03) for _ in range(3)]), 0.0, 1.0)).to(dev)
        for _ in range(n)]


def camera_extent(cams) -> float:
    """The NeRF++ radius the JAX trainer scales its spatial LRs by: 1.1 x
    the largest distance of a camera from the cameras' mean centre."""
    centres = torch.stack([c.camera_center for c in cams])
    return 1.1 * float((centres - centres.mean(dim=0)).norm(dim=1).max())


class StageTimer:
    """`stage(name)` for make_train_step: CUDA events around each phase
    (named for torch.profiler too), summed by name."""

    def __init__(self):
        self.marks = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.profiler.record_function(name):
            yield
        stop.record()
        self.marks.append((name, start, stop))

    def ms(self):
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.marks:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class Trainer:
    """The training main path at one size: mv orbit views with smooth
    targets, the default OptimizationConfig, every loss term on, in the
    rasterizer configuration `tile16`.  `step` takes one SVC step from the
    carried (params, opt_state, stats)."""

    def __init__(self, params, state, cfg, seed, dev, tile16=False):
        self.state, self.cfg, self.dev = state, cfg, dev
        self.tile16 = tile16
        self.cams = orbit_cameras(MV, dev)
        self.gts = smooth_targets(MV, seed, dev)
        self.bg = torch.zeros(3, device=dev)
        self.opt = OptimizationConfig()
        self.extent = camera_extent(self.cams)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.iteration = 0
        self.rebuild(params, 0)

    def rebuild(self, params, level: int):
        """A new optimizer for `level`, as the JAX trainer rebuilds it when
        the level rises: fresh moments and statistics, the schedules'
        counts fast-forwarded to the iteration."""
        self.level = level
        self.tx = make_optimizer(self.opt, params, self.extent, level,
                                 device=self.dev)
        opt_state = self.tx.init(params)
        opt_state["sched_count"] = {
            g: torch.full_like(c, self.iteration)
            for g, c in opt_state["sched_count"].items()}
        stats = init_stats(params["anchors"]["anchor"].shape[0],
                           self.cfg.n_offsets, device=self.dev)
        self.carry = (params, opt_state, stats)
        self.fn = make_train_step(self.cfg, self.opt, MV, level, self.tx,
                                  device=self.dev, tile16=self.tile16)

    def step(self, stage=None, carry=None, generator=None):
        carry = carry or self.carry
        out = self.fn(*carry[:2], self.state.active, self.state.contractor,
                      carry[2], self.cams, self.gts, self.bg,
                      generator or self.generator, self.iteration,
                      TERMS["consistency_on"], TERMS["tv_w"],
                      TERMS["stats_on"], stage=stage)
        self.iteration += 1
        self.carry = out[:3]
        return out[3]

    def check_trained(self, before):
        """Every leaf of a group with lr > 0 that got a gradient (a
        nonzero first moment) moved, every leaf of a frozen group stayed,
        and all are finite.  Returns (moved, trained) leaf counts."""
        params, opt_state, _ = self.carry
        labels = flat(label_params(params))
        scheds = group_schedules(self.opt, self.extent, self.level)
        lr = {g: float(fn(opt_state["sched_count"][g]))
              for g, fn in scheds.items()}
        after, mu = flat(params), flat(opt_state["mu"])
        moved = trained = 0
        for key, leaf in after.items():
            if not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"{key} is not finite")
            changed = not torch.equal(leaf, before[key])
            if lr[labels[key]] == 0.0 and changed:
                raise AssertionError(f"frozen leaf {key} moved")
            if lr[labels[key]] > 0.0 and bool(mu[key].any()):
                trained += 1
                if not changed:
                    raise AssertionError(f"trained leaf {key} did not move")
                moved += 1
        return moved, trained


def train_phase(params, state, cfg, args, dev, tile16=False):
    """Phases 7 and 13: returns the trainer (its carry is the state after
    the last step), the launches and ms/step."""
    trainer = Trainer(params, state, cfg, args.seed, dev, tile16)
    before = flat(params)
    metrics = []
    cuda_lib.LAUNCHES.clear()
    metrics.append(trainer.step())  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):
        metrics.append(trainer.step())
    stop.record()
    stop.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    step_ms = start.elapsed_time(stop) / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    timer = StageTimer()
    metrics.append(trainer.step(stage=timer))
    stages = timer.ms()
    moved0 = trainer.check_trained(before)
    level0 = trainer.carry
    before = flat(level0[0])
    trainer.rebuild(level0[0], 2)
    for _ in range(2):
        metrics.append(trainer.step())
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    moved2 = trainer.check_trained(before)
    n_steps = len(metrics)

    losses = [{k: float(m[k]) for k in ("loss", "l1", "con")}
              for m in metrics]
    print(f"training ({tile_of(tile16)} px tiles, kmax {cfg.kmax}): {MV} "
          f"views at {WIDTH}x{HEIGHT}, {n_steps} steps "
          f"(1 warm-up, {args.steps} timed, 1 staged at level 0; 2 at "
          f"level 2), spatial lr scale {trainer.extent:.4f}; "
          f"{step_ms:.3f} ms/step (CUDA events), {wall_ms:.3f} ms/step "
          f"(host clock), peak device memory {peak_gib:.3f} GiB; launches "
          f"{launches}")
    print(f"loss trajectory: {json.dumps([round(l['loss'], 6) for l in losses])}")
    print(f"l1 {json.dumps([round(l['l1'], 6) for l in losses])} con "
          f"{json.dumps([round(l['con'], 6) for l in losses])}")
    print(f"max_slots {int(metrics[-1]['max_slots'])} num_clipped (sum "
          f"over views) {int(metrics[-1]['num_clipped'])}")
    print(f"level-0 step stages ms (CUDA events): {json.dumps(stages)}")
    print(f"trained leaves moved: level 0 {moved0[0]}/{moved0[1]}, level 2 "
          f"{moved2[0]}/{moved2[1]}")
    if not all(math.isfinite(v) for l in losses for v in l.values()):
        raise AssertionError("a training loss is not finite")
    if not losses[0]["con"] > 0.0:
        raise AssertionError("the consistency term did not run")
    kernels = (FWD_KERNELS[tile_of(tile16)], BWD_KERNELS[tile_of(tile16)])
    if launches != {name: MV * n_steps for name in kernels}:
        raise AssertionError(f"training launched {launches} for {n_steps} "
                             f"steps of {MV} views: each of {kernels} "
                             f"{MV * n_steps} times, nothing else")
    return trainer, launches, step_ms


def view_cotangent(trainer, view: int):
    """A training view rendered from the trainer's params (no noise) and
    the cotangent its photometric loss sends back to the image: binned
    records, padded grad, rgb and T_final."""
    params, cfg, cam = trainer.carry[0], trainer.cfg, trainer.cams[view]
    with torch.no_grad():
        binned, _ = frame_stages(params, trainer.state, cam, cfg,
                                 trainer.level, trainer.tile16)
        tiles_x, tiles_y = grid(trainer.tile16)
        rgb, t_fin = raster_fwd(binned.records, binned.tile_start,
                                binned.tile_end, tiles_x, tiles_y,
                                cam.image_height, cam.image_width,
                                tile=tile_of(trainer.tile16))
    image = (rgb + trainer.bg[:, None, None] * t_fin[None])[
        :, :HEIGHT, :WIDTH].requires_grad_()
    lam = trainer.opt.lambda_dssim
    gt = trainer.gts[view]
    loss = (1.0 - lam) * l1_loss(image, gt) + lam * (1.0 - ssim(image, gt))
    (g_img,) = torch.autograd.grad(loss, image)
    grad = torch.zeros_like(rgb)
    grad[:, :HEIGHT, :WIDTH] = g_img
    return binned, grad, rgb, t_fin


def steps_repeat(trainer, seed: int):
    """Phase 9: two steps from the same state (and the same noise seed)
    give bit-identical params, optimizer state and statistics."""
    carry = trainer.carry
    outs = []
    for _ in range(2):
        trainer.step(carry=carry, generator=torch.Generator(
            device=trainer.dev).manual_seed(seed))
        p, o, st = trainer.carry
        outs.append({**flat(p, "params"), **flat(o, "opt"),
                     **{f"stats.{f}": getattr(st, f)
                        for f in ("opacity_accum", "anchor_demon",
                                  "offset_gradient_accum", "offset_denom")}})
    torch.cuda.synchronize()
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"determinism: two steps from the same state, {len(outs[0])} "
          f"tensors, {len(differ)} differ {differ[:8]}")
    if differ:
        raise AssertionError("two training steps from the same state differ")
    trainer.carry = carry


def small_step_agrees(seed: int, dev: torch.device) -> float:
    """Phase 10: one step (q = 0) of a small model on the card and on the
    CPU, from the same seeded params; the losses agree to 1e-4 relative
    (matmul, exp and pixel sums round differently on the two)."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0])
    pts = np.random.default_rng(seed).normal(size=(300, 3)).astype(
        np.float32) * 0.4
    losses = []
    for d in (dev, torch.device("cpu")):
        params, state = init_model(cfg, pts, device=d,
                                   generator=torch.Generator().manual_seed(
                                       seed))
        cams = [look_at_camera(e, [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48,
                               uid=i, device=d)
                for i, e in enumerate([[0, 0, -3.0], [0.5, 0.3, -2.8]])]
        gts = [torch.full((3, 48, 64), v, device=d) for v in (0.6, 0.4)]
        opt = OptimizationConfig()
        tx = make_optimizer(opt, params, 1.0, 0, device=d)
        step = make_train_step(cfg, opt, 2, 0, tx, q_noise=0.0, device=d)
        out = step(params, tx.init(params), state.active, state.contractor,
                   init_stats(params["anchors"]["anchor"].shape[0],
                              cfg.n_offsets, device=d),
                   cams, gts, torch.zeros(3, device=d), None, 0,
                   TERMS["consistency_on"], TERMS["tv_w"],
                   TERMS["stats_on"])
        losses.append(float(out[3]["loss"]))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"small model step card vs CPU: loss {losses[0]:.8f} vs "
          f"{losses[1]:.8f}, rel {rel:.3e}")
    if not rel <= 1e-4:
        raise AssertionError("card and CPU training steps disagree")
    return rel


def kernel_checks(proj, colors, opac, seed: int, dev, tile16: bool,
                  kmax: int):
    """Phases 3 and 11: the blend kernel and its backward of the
    configuration against their plain versions on a random scene."""
    tile = tile_of(tile16)
    binned, tiles_x, tiles_y = bin_frame(proj, colors, opac, tile, HEIGHT,
                                         WIDTH, kmax)
    err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y, tile=tile)
    print(f"random scene, {tile} px tiles, kmax {kmax}: "
          f"{binned.records.shape[1]} pairs, clipped "
          f"{int(binned.num_clipped)}; kernel vs plain max |d| rgb "
          f"{err_rgb:.3e} T {err_t:.3e} (must be 0)")
    if not max(err_rgb, err_t) == 0.0:
        raise AssertionError(f"the {tile} px blend kernel disagrees with its "
                             "plain version")
    rgb, t_fin = raster_fwd(binned.records, binned.tile_start,
                            binned.tile_end, tiles_x, tiles_y, HEIGHT, WIDTH,
                            tile=tile)
    grad = torch.zeros_like(rgb)
    grad[:, :HEIGHT, :WIDTH] = torch.randn(
        (3, HEIGHT, WIDTH), generator=torch.Generator().manual_seed(
            seed)).to(dev)
    err_abs, err_row = compare_bwd(binned, tiles_x, tiles_y, grad, rgb,
                                   t_fin, torch.tensor([0.2, 0.3, 0.4],
                                                       device=dev),
                                   tile=tile)
    print(f"random scene, {tile} px tiles: backward kernel vs plain max "
          f"|d| {err_abs:.3e}, largest row-relative {err_row:.3e} "
          f"(tolerance {RASTER_BWD_TOL}); two launches bit-identical")
    if not err_row <= RASTER_BWD_TOL:
        raise AssertionError(f"the {tile} px backward kernel disagrees with "
                             "its plain version")


def render_phase(params, state, cfg, cams, level: int, dev, tile16: bool):
    """Phases 4-5 and 12: `render_set` over `cams` in the configuration
    (launches counted from 0 around it), frame 0's render and stages, and
    the blend kernel at frame 0's shapes against its plain version and
    its bound.  Returns the kernel's numbers."""
    tile = tile_of(tile16)
    name = FWD_KERNELS[tile]
    frames = len(cams)
    with tempfile.TemporaryDirectory() as out_dir:
        cuda_lib.LAUNCHES.clear()
        fps = render_set(out_dir, "orbit", 0, cams, params, state.active,
                         state.contractor, level, cfg, tile16=tile16)
        launches = dict(cuda_lib.LAUNCHES)
    print(f"render_set ({tile} px tiles, kmax {cfg.kmax}): {frames} frames "
          f"at {WIDTH}x{HEIGHT}, {1e3 / fps:.3f} ms/frame (CUDA events, "
          f"after a warm-up frame); launches {launches}")
    if launches != {name: frames}:
        raise AssertionError(f"render_set launched {launches} for {frames} "
                             "frames")

    tiles_x, tiles_y = grid(tile16)
    with torch.inference_mode():
        vis = prefilter_voxel(params["anchors"], state.active, cams[0])
        out = render(params, state.active, state.contractor, cams[0],
                     torch.zeros(3, device=dev), visible_mask=vis,
                     activate_level=level, kmax=cfg.kmax, tile16=tile16,
                     **decode_kwargs(cfg))
        img = out.image
        if img.shape != (3, HEIGHT, WIDTH) or not bool(
                torch.isfinite(img).all()) or not float(img.std()) > 0:
            raise AssertionError("main-path image is not finite and varied")
        print(f"frame 0 ({tile} px tiles): {out.num_pairs} pairs, "
              f"num_clipped {int(out.num_clipped)}, max_slots "
              f"{int(out.max_slots)}, selected "
              f"{int(out.selection_mask.sum())} gaussians, image mean "
              f"{float(img.mean()):.4f} std {float(img.std()):.4f}")

        frame_stages(params, state, cams[0], cfg, level, tile16)  # warm-up
        binned, stages = frame_stages(params, state, cams[0], cfg, level,
                                      tile16)
        print(f"frame 0 stages ms ({tile} px tiles, CUDA events): "
              f"{json.dumps(stages)}")
        print(f"frame 0 ({tile} px tiles): "
              f"{records_and_cull(binned, tiles_x, tiles_y, tile)}")
        work = {}
        err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y, work,
                                        tile=tile)
        err = max(err_rgb, err_t)
        print(f"main path ({tile} px tiles): kernel vs plain max |d| rgb "
              f"{err_rgb:.3e} T {err_t:.3e} (must be 0)")
        if not err == 0.0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "at the main path's shapes")
        rargs = (binned.records, binned.tile_start, binned.tile_end,
                 tiles_x, tiles_y, HEIGHT, WIDTH)
        kernel_ms = cuda_time_ms(lambda: raster_fwd(*rargs, tile=tile), 20)
        plain_ms = cuda_time_ms(
            lambda: raster_fwd_plain(*rargs, tile=tile), 2)
    bnd = fwd_bound(binned, work, tiles_x, tiles_y, tile)
    print(f"{name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms")
    return {"launches": launches, "err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound": bnd}


def records_and_cull(binned, tiles_x, tiles_y, tile,
                     kernels=("forward",)) -> str:
    """The records per tile (max / p99 / mean) and the share of (record,
    warp) pairs the per-warp cull of each of `kernels` ("forward",
    "backward") skips."""
    count = (binned.tile_end - binned.tile_start).to(torch.float64)
    masks = {"forward": fwd_cull_mask, "backward": bwd_cull_mask}
    shares = []
    for kernel in kernels:
        skipped = masks[kernel](binned.records, binned.tile_start,
                                binned.tile_end, tiles_x, tiles_y, tile)
        shares.append(f"{kernel} {float(skipped.float().mean()):.4f}")
    return (f"records per tile max {int(count.max())} p99 "
            f"{float(torch.quantile(count, 0.99)):.1f} mean "
            f"{float(count.mean()):.2f}; share of (record, warp) pairs the "
            f"cull skips: {', '.join(shares)}")


def backward_at_view(trainer):
    """Phases 8 and 13: at a training view's shapes, the configuration's
    forward kernel against its plain version (bit for bit) and timed
    beside its bound, and its backward kernel (with that view's loss
    cotangent) against its plain version and its bound; the view's records
    per tile and the share of (record, warp) pairs each kernel's cull
    skips.  Returns the backward's numbers."""
    tile = tile_of(trainer.tile16)
    name = BWD_KERNELS[tile]
    tiles_x, tiles_y = grid(trainer.tile16)
    binned, grad, rgb, t_fin = view_cotangent(trainer, MV - 1)
    view = f"training view {MV - 1} ({tile} px tiles)"
    print(f"{view}: " + records_and_cull(binned, tiles_x, tiles_y, tile,
                                          ("forward", "backward")))
    work = {}
    err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y, work, tile=tile)
    print(f"{view}: forward kernel vs plain max |d| rgb {err_rgb:.3e} T "
          f"{err_t:.3e} (must be 0)")
    if not max(err_rgb, err_t) == 0.0:
        raise AssertionError(f"{FWD_KERNELS[tile]} disagrees with its plain "
                             "version at the training path's shapes")
    fargs = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
             tiles_y, HEIGHT, WIDTH)
    fwd_ms = cuda_time_ms(lambda: raster_fwd(*fargs, tile=tile), 20)
    fbnd = fwd_bound(binned, work, tiles_x, tiles_y, tile)
    print(f"{view}: {FWD_KERNELS[tile]} {fwd_ms:.4f} ms, bound "
          f"{fbnd[0]:.4f} ms ({fbnd[1]}), {fbnd[0] / fwd_ms:.1%} of it")
    work = {}
    err, row = compare_bwd(binned, tiles_x, tiles_y, grad, rgb, t_fin,
                           trainer.bg, work, tile=tile)
    print(f"{view}: backward kernel vs plain max |d| {err:.3e}, largest "
          f"row-relative {row:.3e}")
    if not row <= RASTER_BWD_TOL:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             "the training path's shapes")
    bargs = fargs + (grad, rgb, t_fin, trainer.bg)
    ms = cuda_time_ms(lambda: raster_bwd(*bargs, tile=tile), 20)
    plain_ms = cuda_time_ms(lambda: raster_bwd_plain(*bargs, tile=tile), 2)
    bnd = bwd_bound(binned, work, tiles_x, tiles_y, tile)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd}


def window_columns(starts: np.ndarray) -> int:
    """Distinct columns the 128-column windows at `starts` cover: what a
    probe must read of each row it reads."""
    cols = starts.astype(np.int64)[:, None] + np.arange(probes.WIN)
    return int(np.unique(cols).size)


def probe_checks(micro, dev):
    """Phase 14, the probes of tools/micro_mosaic_torch.py: each kernel in
    each mode against its plain version on the card (launches not
    counted), the plain versions (and torch.cumsum) timed, the bounds.
    `micro` is the tool's run (its kernel times).  Returns {kernel: the
    numbers of its `kernels` entry}."""
    import micro_mosaic_torch as mm

    def ms_of(key):
        return micro[key]["ms"]

    inp = mm.inputs()
    res = {}

    # 5a: window row sums, at the tool's starts and at p % 128 = 0 / 127
    data = torch.as_tensor(inp["data"], device=dev)
    width = data.shape[1]
    edge = torch.tensor([0, 127, 128, 255, 4096, width - 257, width - 256,
                         width - 129], dtype=torch.int32, device=dev)
    starts = torch.as_tensor(inp["starts"], device=dev)
    errs = {m: 0.0 for m in probes.EXTRACT_MODES}
    for st in (starts, edge):
        want = probes.extract_rows_plain(data, st)
        for mode in probes.EXTRACT_MODES:
            got = probes.extract_rows(data, st, mode)
            errs[mode] = max(errs[mode], float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"extract[{mode}] differs from its "
                                     "plain version")
    n = starts.shape[0]
    bnd = bound(4 * probes.REC * window_columns(inp["starts"]) + 4 * n
                + 4 * n * probes.OUT_ROWS * probes.REC,
                probes.REC * n * (probes.WIN - 1))
    res[probes.EXTRACT] = {
        "err": max(errs.values()), "ms": ms_of("extract[direct]"),
        "plain_ms": cuda_time_ms(
            lambda: probes.extract_rows_plain(data, starts), 5),
        "bound": bnd, "modes": {m: {"max_abs_err": errs[m],
                                    "ms": ms_of(f"extract[{m}]")}
                                for m in probes.EXTRACT_MODES}}
    print(f"{probes.EXTRACT}: every mode equals the plain version bit for "
          f"bit (tool's starts and p % 128 = 0 / 127); bound "
          f"{bnd[0]:.6f} ms ({bnd[1]})")

    # 5b: cumsum, fp32 against the plain version, TF32 against float64
    xs = torch.as_tensor(inp["xs"], device=dev)
    plain = probes.cumsum_rows_plain(xs)
    ref64 = torch.cumsum(xs.double(), dim=0)
    scale = float(ref64.abs().max())
    rows, cols = xs.shape
    macs = rows * (rows + 1) // 2 * cols  # L's nonzero part
    modes = {}
    for mode, peak in (("tf32", PEAK_TF32_PER_S), ("fp32", PEAK_FP32_PER_S)):
        got = probes.cumsum_rows(xs, mode)
        d_plain = float((got - plain).abs().max())
        d64 = float((got.double() - ref64).abs().max()) / scale
        modes[mode] = {"max_abs_err": d_plain, "rel_err_float64": d64,
                       "ms": ms_of(f"cumsum[{mode}]"),
                       "bound": bound(2 * 4 * rows * cols, 2 * macs, peak)}
        print(f"{probes.CUMSUM}[{mode}]: vs plain max |d| {d_plain:.3e}, "
              f"vs float64 {d64:.3e} of the max; bound "
              f"{modes[mode]['bound'][0]:.6f} ms ({modes[mode]['bound'][1]})")
    if not modes["fp32"]["max_abs_err"] <= CUMSUM_FP32_TOL * scale:
        raise AssertionError("the fp32 cumsum differs from its plain version")
    if not modes["tf32"]["rel_err_float64"] <= CUMSUM_TF32_TOL:
        raise AssertionError("the TF32 cumsum is off by more than "
                             f"{CUMSUM_TF32_TOL} of the max")
    res[probes.CUMSUM] = {
        "err": max(m["max_abs_err"] for m in modes.values()),
        "ms": modes["tf32"]["ms"], "bound": modes["tf32"]["bound"],
        "plain_ms": cuda_time_ms(lambda: probes.cumsum_rows_plain(xs), 5),
        "library_ms": cuda_time_ms(lambda: torch.cumsum(xs, dim=0),
                                   PROBE_ITERS),
        "modes": {m: {k: v for k, v in d.items() if k != "bound"}
                  for m, d in modes.items()}}

    # 5c: accumulation in place
    ones = torch.ones((8, 128), device=dev)
    got = probes.accumulate_(torch.zeros_like(ones), ones)
    want = probes.accumulate_plain_(torch.zeros_like(ones), ones)
    if not (torch.equal(got, want) and bool((got == 2.0).all())):
        raise AssertionError("the accumulation probe is not 2.0 everywhere")
    buf = torch.zeros_like(ones)
    res[probes.ACCUM] = {
        "err": float((got - want).abs().max()), "ms": ms_of("accum"),
        "plain_ms": cuda_time_ms(
            lambda: probes.accumulate_plain_(buf, ones), PROBE_ITERS),
        # one call: on the zeroed buffer, out + 2 in is (out + in) + in
        "library_ms": cuda_time_ms(
            lambda: buf.add_(ones, alpha=probes.ACC_STEPS // 2), PROBE_ITERS),
        "bound": bound(3 * 4 * ones.numel(), probes.ACC_STEPS // 2
                       * ones.numel())}
    print(f"{probes.ACCUM}: 2.0 everywhere, equal to the plain version")

    # 5d: alpha sums.  The tool's row 2 is N(0, 1): where it is negative
    # exp overflows and the sums are +-inf or NaN, so the kernel is held
    # to its plain version on the same inputs with row 2 made positive
    big = torch.as_tensor(inp["big"], device=dev)
    st2 = torch.as_tensor(inp["st2"], device=dev)
    for extract in probes.BLEND_MODES:
        got = probes.alpha_sums(big, st2, extract)
        print(f"{probes.BLEND}[extract={extract}] on the tool's inputs: "
              f"{int((~torch.isfinite(got)).sum())} of {got.numel()} sums "
              "not finite")
    pos = big.clone()
    pos[2] = pos[2].abs()
    modes = {}
    for extract in probes.BLEND_MODES:
        got = probes.alpha_sums(pos, st2, extract)
        want = probes.alpha_sums_plain(pos, st2, extract)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        modes[f"extract={extract}"] = {
            "max_abs_err": err, "ms": ms_of(f"blend[extract={extract}]")}
        print(f"{probes.BLEND}[extract={extract}] (|row 2|): vs plain max "
              f"|d| {err:.3e}, {rel:.3e} of the max")
        if not rel <= BLEND_PROBE_TOL:
            raise AssertionError(f"{probes.BLEND} differs from its plain "
                                 "version")
    n = st2.shape[0]
    bnd = bound(4 * 3 * window_columns(inp["st2"]) + 4 * n
                + 4 * n * probes.PIX, 7 * n * probes.PIX * probes.WIN)
    res[probes.BLEND] = {
        "err": max(m["max_abs_err"] for m in modes.values()),
        "ms": modes["extract=True"]["ms"],
        "plain_ms": cuda_time_ms(
            lambda: probes.alpha_sums_plain(big, st2, True), 2),
        "bound": bnd, "modes": modes}
    print(f"{probes.BLEND}: bound {bnd[0]:.6f} ms ({bnd[1]})")
    return res


def ablation_checks(ablate):
    """Phase 14, the ablation of tools/profile_torch_kernel_v3.py: each
    variant's kernel output from the tool's run against its plain version
    (full, nostage and noaccum to the forward's bound, noaccum's rgb 0),
    the plain versions timed.  Returns the numbers of its `kernels`
    entry."""
    args = ablate["args"]
    modes = {}
    for variant in raster_ablate.VARIANTS:
        rgb, t_fin = ablate["out"][variant]
        p_rgb, p_t = raster_ablate.raster_fwd16_ablate_plain(*args, variant)
        err = max(float((rgb - p_rgb).abs().max()),
                  float((t_fin - p_t).abs().max()))
        modes[variant] = {
            "max_abs_err": err, "ms": ablate["ms"][variant],
            "plain_ms": cuda_time_ms(
                lambda: raster_ablate.raster_fwd16_ablate_plain(*args,
                                                               variant), 2)}
        print(f"{raster_ablate.KERNEL}[{variant}]: vs plain max |d| "
              f"{err:.3e}")
        if not err <= RASTER_TOL:
            raise AssertionError(f"{raster_ablate.KERNEL}[{variant}] differs "
                                 "from its plain version")
    full, noaccum = ablate["out"]["full"], ablate["out"]["noaccum"]
    if bool(noaccum[0].any()) or not torch.equal(noaccum[1], full[1]):
        raise AssertionError("noaccum: rgb must be 0 and T full's")
    return {"err": max(m["max_abs_err"] for m in modes.values()),
            "ms": modes["full"]["ms"], "plain_ms": modes["full"]["plain_ms"],
            "bound": ablate["bound"], "modes": modes}


def probe_phase(dev):
    """Phase 14: both tools driven through `run` with the launch counts
    from 0, then the checks.  Returns ({kernel: launches}, {kernel: the
    numbers of its `kernels` entry})."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import micro_mosaic_torch as mm
    import profile_torch_kernel_v3 as pk

    cuda_lib.LAUNCHES.clear()
    micro = mm.run(dev, PROBE_ITERS)
    ablate = pk.run(dev, PROBE_ITERS)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"probe and ablation launches: {launches}")
    # a checked launch, a warm-up and the timed ones; the alpha-sum probe
    # is only timed, as in the JAX tool
    each = 2 + PROBE_ITERS
    want = {f"{probes.CUMSUM}[{m}]": each for m in probes.CUMSUM_MODES}
    want.update({f"{probes.EXTRACT}[{m}]": each
                 for m in probes.EXTRACT_MODES})
    want[probes.ACCUM] = each
    want.update({f"{probes.BLEND}[extract={e}]": 1 + PROBE_ITERS
                 for e in probes.BLEND_MODES})
    want.update({f"{raster_ablate.KERNEL}[{v}]": each
                 for v in raster_ablate.VARIANTS})
    if launches != want:
        raise AssertionError(f"the tools launched {launches}, not {want}")
    failed = [k for k, r in micro.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"probes failed their bounds: {failed}")
    numbers = probe_checks(micro, dev)
    numbers[raster_ablate.KERNEL] = ablation_checks(ablate)
    per_kernel = {name: sum(v for k, v in launches.items()
                            if k.split("[")[0] == name)
                  for name in numbers}
    return per_kernel, numbers


def png_pixels(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an RGB PNG whose rows are all unfiltered (what
    save_png writes), decoded here without the port's decoder."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(
                body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row is filtered")
    return rows[:, 1:].reshape(h, w, 3)


def eight_bit(img: torch.Tensor) -> np.ndarray:
    """[H, W, 3] uint8 of a [3, H, W] image as save_png quantizes it."""
    return (img.clamp(0.0, 1.0).permute(1, 2, 0).cpu().numpy() * 255
            ).astype(np.uint8)


def write_scene(tmp: str, args, dev) -> str:
    """Phases 15-16's COLMAP scene, written under `tmp`."""
    scene_dir = os.path.join(tmp, "scene")
    t0 = time.perf_counter()
    write_colmap_dataset(scene_dir, n_views=DISK_VIEWS, n_pts=DISK_POINTS,
                         width=WIDTH, height=HEIGHT, seed=args.seed,
                         device=dev)
    torch.cuda.synchronize()
    print(f"scene on disk: {DISK_VIEWS} views at {WIDTH}x{HEIGHT}, "
          f"{DISK_POINTS} points, written in "
          f"{time.perf_counter() - t0:.1f} s")
    return scene_dir


def disk_phase(args, dev, card: str, scene_dir: str):
    """Phase 15: the COLMAP scene at `scene_dir` read and rendered from
    disk at full width, through the entry points a user calls.  Returns
    the forward kernel's launches in render_sets."""
    t_phase = time.perf_counter()
    name = FWD_KERNELS[raster_v3.TILE if TILE16_DEFAULT else TILE]
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "model")
        points_bin = os.path.join(scene_dir, "sparse", "0", "points3D.bin")
        t0 = time.perf_counter()
        native_io.read_points3d(points_bin)  # builds the parser
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        xyz, _, _ = native_io.read_points3d(points_bin)
        parse_s = time.perf_counter() - t0

        cfg = dataclasses.replace(quickstart_config(), source_path=scene_dir,
                                  model_path=model_dir, eval=True)
        t0 = time.perf_counter()
        scene = Scene(cfg, shuffle=False, device=dev)
        train, test = scene.train_cameras(), scene.test_cameras()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if (len(train), len(test)) != (DISK_VIEWS - 2, 2):
            raise AssertionError(f"split {len(train)} / {len(test)}")
        for cam in train + test:
            want = png_pixels(os.path.join(scene_dir, "images",
                                           cam.image_name + ".png"))
            got = cam.image.permute(1, 2, 0).cpu().numpy() * 255
            if not (cam.image.shape == (3, HEIGHT, WIDTH)
                    and np.array_equal(np.round(got), want)
                    and np.abs(got - want).max() < 1e-3):
                raise AssertionError(f"{cam.image_name}: the ground truth is "
                                     "not the written PNG's pixels")

        params, state = init_model(cfg, scene.points, device=dev,
                                   generator=torch.Generator().manual_seed(
                                       args.seed))
        n_anchor = int(state.active.sum())
        # the capacity the checkpoint loads at (anchors padded to 256), so
        # both models run the same shapes
        cap = round_up(n_anchor, 256)
        params["anchors"] = {k: v[:cap] for k, v in
                             params["anchors"].items()}
        active = state.active[:cap]
        save_model_checkpoint(model_dir, DISK_ITERATION, params, active)
        save_run_config(model_dir, cfg, PipelineConfig(),
                        OptimizationConfig())
        cli_dir = os.path.join(tmp, "model_cli")
        shutil.copytree(model_dir, cli_dir)

        cuda_lib.LAUNCHES.clear()
        fps, n = render_sets(cfg, device=dev)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        frames = DISK_VIEWS
        out = {split: os.path.join(model_dir, split,
                                   f"ours_{DISK_ITERATION}", "renders")
               for split in ("train", "test")}
        counts = {split: len(os.listdir(d)) for split, d in out.items()}
        with open(os.path.join(model_dir, "num_gaussians.json")) as fh:
            n_json = json.load(fh)["model"]
        print(f"render_sets from disk: {counts} PNGs, {n} anchors "
              f"(num_gaussians.json {n_json}, active {n_anchor}); launches "
              f"{launches}")
        if counts != {"train": DISK_VIEWS - 2, "test": 2}:
            raise AssertionError("render_sets wrote the wrong PNGs")
        if not n == n_json == n_anchor:
            raise AssertionError("num_gaussians.json's anchors are not the "
                                 "model's")
        if launches != {name: frames}:
            raise AssertionError(f"render_sets launched {launches} for "
                                 f"{frames} frames")

        loaded, l_active, contractor, level, _ = load_trained(cfg,
                                                              device=dev)
        bg = torch.zeros(3, device=dev)
        images = []
        with torch.inference_mode():
            for p, a, c in ((loaded, l_active, contractor),
                            (params, active, state.contractor)):
                vis = prefilter_voxel(p["anchors"], a, test[0])
                images.append(render(p, a, c, test[0], bg, visible_mask=vis,
                                     activate_level=level, kmax=cfg.kmax,
                                     **decode_kwargs(cfg)).image)
        png = png_pixels(os.path.join(out["test"], "00000.png"))
        print(f"first test view: loaded vs in-memory model max |d| "
              f"{float((images[0] - images[1]).abs().max()):.3e} (must be "
              f"0); its PNG equals the in-memory render quantized: "
              f"{np.array_equal(png, eight_bit(images[1]))}")
        if not torch.equal(images[0], images[1]):
            raise AssertionError("the loaded checkpoint renders otherwise "
                                 "than the in-memory model")
        if not np.array_equal(png, eight_bit(images[1])):
            raise AssertionError("render_sets' PNG is not the in-memory "
                                 "model's render")

        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent
                                 / "render_torch.py"),
             "-m", cli_dir, "--skip_train"], capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"render_torch.py failed:\n{res.stdout}"
                                 f"{res.stderr}")
        cli_out = os.path.join(cli_dir, "test", f"ours_{DISK_ITERATION}",
                               "renders")
        same = sorted(os.listdir(cli_out)) == sorted(os.listdir(out["test"]))
        for f in os.listdir(out["test"]):
            with open(os.path.join(out["test"], f), "rb") as a, \
                    open(os.path.join(cli_out, f), "rb") as b:
                same = same and a.read() == b.read()
        print(f"render_torch.py --skip_train: {cli_s:.1f} s, its PNGs equal "
              f"render_sets': {same}")
        if not same:
            raise AssertionError("render_torch.py wrote other PNGs")
    print(f"scene on disk ({card}): {DISK_VIEWS} views at {WIDTH}x{HEIGHT}; "
          f"native parser built and first read "
          f"in {first_s:.3f} s, then {len(xyz)} points in "
          f"{parse_s * 1e3:.2f} ms = {len(xyz) / parse_s:.4g} points/s; "
          f"Scene load (parse, decode, to the card) {load_s:.3f} s; "
          f"render_sets ({name}) train {1e3 / fps['train']:.3f} ms/frame, "
          f"test {1e3 / fps['test']:.3f} ms/frame (CUDA events, after a "
          f"warm-up frame); phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


class TrainProbe:
    """Phase 16's instruments, installed on splatco_torch's Trainer for
    the length of a `with`: CUDA events around every SVC step (whose loss
    it keeps, on the card) and around each stage of step `staged_step`,
    the host clock after a synchronize around each densify call, graph
    downsample, eval and save (and TensorBoard's `add_image` inside eval,
    where TensorBoard is installed), and a record of every kmax
    escalation and capacity regrowth.  Step `staged_step`'s first view
    also leaves copies of its blend kernels' inputs in `raster`: "fwd"
    the forward's arguments, "bwd" the backward's cotangent, rgb, T and
    bg for the same records, with the step's kmax and capacity.  Steps `profiled` (consecutive) run under
    torch.profiler, left in `profiler`."""

    TIMED = ("_cvpm_and_densify", "_graph_downsample", "evaluate",
             "save_model", "save_training_state")

    def __init__(self, staged_step: int, profiled=()):
        self.staged_step, self.stages = staged_step, StageTimer()
        self.events, self.losses = [], []
        self.seconds = {name: [] for name in self.TIMED}
        self.kmax, self.grows = [], []
        self.raster, self.capturing = {}, False
        self.profiled, self.profiler = tuple(profiled), None

    def steady_ms(self):
        """The CUDA-event times of the steps other than the first (its
        allocations), the staged one and the profiled ones."""
        skip = {1, self.staged_step, *self.profiled}
        return [ms for n, ms in enumerate(self.step_ms(), 1)
                if n not in skip]

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    @contextlib.contextmanager
    def installed(self):
        cls = train_loop.Trainer
        saved = {name: getattr(cls, name) for name in
                 self.TIMED + ("_get_step", "_grow", "_escalate_kmax")}

        def timed(name):
            def wrapper(tr, *a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = saved[name](tr, *a, **kw)
                torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)
                return out
            return wrapper

        def get_step(tr):
            step = saved["_get_step"](tr)

            def timed_step(*a, **kw):
                n = len(self.events) + 1
                if n == self.staged_step:
                    kw["stage"] = self.stages
                    self.capturing = True
                    self.raster.update(
                        kmax=tr.cfg.kmax,
                        capacity=tr.params["anchors"]["anchor"].shape[0])
                if self.profiled and n == self.profiled[0]:
                    from torch.profiler import ProfilerActivity, profile
                    torch.cuda.synchronize()
                    self.profiler = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    self.profiler.start()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*a, **kw)
                stop.record()
                self.capturing = False
                if self.profiled and n == self.profiled[-1]:
                    torch.cuda.synchronize()
                    self.profiler.stop()
                self.events.append((start, stop))
                self.losses.append(out[3]["loss"])
                return out
            return timed_step

        raster_fwd0 = rasterize_ops.raster_fwd
        raster_bwd0 = rasterize_ops.raster_bwd

        def copies(args):
            return tuple(a.clone() if torch.is_tensor(a) else a
                         for a in args)

        def capture_fwd(*a, **kw):
            if self.capturing and "fwd" not in self.raster:
                self.raster["fwd"] = copies(a)
                self.raster["records_ptr"] = a[0].data_ptr()
            return raster_fwd0(*a, **kw)

        def capture_bwd(*a, **kw):
            if (self.capturing and "bwd" not in self.raster
                    and a[0].data_ptr() == self.raster.get("records_ptr")):
                self.raster["bwd"] = copies(a[7:11])
            return raster_bwd0(*a, **kw)

        def grow(tr, new_capacity):
            old = tr.params["anchors"]["anchor"].shape[0]
            saved["_grow"](tr, new_capacity)
            self.grows.append((old, tr.params["anchors"]["anchor"].shape[0]))

        def escalate(tr, num_clipped):
            old = tr.cfg.kmax
            saved["_escalate_kmax"](tr, num_clipped)
            if tr.cfg.kmax != old:
                self.kmax.append((old, tr.cfg.kmax, num_clipped))

        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            add_image = SummaryWriter.add_image
            self.seconds["add_image"] = []

            def timed_add_image(writer, *a, **kw):
                t0 = time.perf_counter()
                add_image(writer, *a, **kw)
                self.seconds["add_image"].append(time.perf_counter() - t0)
            SummaryWriter.add_image = timed_add_image
        for name in self.TIMED:
            setattr(cls, name, timed(name))
        cls._get_step, cls._grow, cls._escalate_kmax = get_step, grow, \
            escalate
        rasterize_ops.raster_fwd = capture_fwd
        rasterize_ops.raster_bwd = capture_bwd
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(cls, name, fn)
            rasterize_ops.raster_fwd = raster_fwd0
            rasterize_ops.raster_bwd = raster_bwd0
            if SummaryWriter is not None:
                SummaryWriter.add_image = add_image


def read_npz(path: str) -> dict:
    with np.load(path) as archive:
        return {k: archive[k] for k in archive.files}


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def staged_view_checks(probe, tile: int):
    """Phase 16's blend kernels against their plain versions on the
    inputs the training path gave them: step TRAIN_STAGED's first view,
    as `probe` copied them (the forward bit for bit, the backward to
    RASTER_BWD_TOL of each row's max, two backward launches equal)."""
    records, start, end, tiles_x, tiles_y, h, w = probe.raster["fwd"]
    grad, rgb, t_fin, bg = probe.raster["bwd"]
    if (h, w) != (HEIGHT, WIDTH):
        raise AssertionError(f"step {TRAIN_STAGED} rendered {w}x{h}")
    binned = types.SimpleNamespace(records=records, tile_start=start,
                                   tile_end=end)
    view = (f"step {TRAIN_STAGED}, view 0 (kmax {probe.raster['kmax']}, "
            f"capacity {probe.raster['capacity']}, {tile} px tiles, "
            f"{records.shape[1]} records)")
    print(f"  {view}: " + records_and_cull(binned, tiles_x, tiles_y, tile,
                                            ("forward", "backward")))
    err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y, tile=tile)
    err, row = compare_bwd(binned, tiles_x, tiles_y, grad, rgb, t_fin, bg,
                           tile=tile)
    print(f"  {view}: {FWD_KERNELS[tile]} vs plain max |d| rgb "
          f"{err_rgb:.3e} T {err_t:.3e} (must be 0); {BWD_KERNELS[tile]} vs "
          f"plain max |d| {err:.3e}, largest row-relative {row:.3e}")
    if not max(err_rgb, err_t) == 0.0:
        raise AssertionError(f"{FWD_KERNELS[tile]} disagrees with its plain "
                             f"version at step {TRAIN_STAGED}")
    if not row <= RASTER_BWD_TOL:
        raise AssertionError(f"{BWD_KERNELS[tile]} disagrees with its plain "
                             f"version at step {TRAIN_STAGED}")


def train_disk_phase(args, dev, card: str, scene_dir: str, model1: str):
    """Phase 16: train_torch.main trains the quick-start model on phase
    15's scene into `model1`, in this process so its launches count; a
    copy of its iteration-45 checkpoint is resumed by train_torch.py in a
    subprocess, which must end where the straight run ended, bit for bit.
    The blend kernels are held to their plain versions on step
    TRAIN_STAGED's inputs.  Returns the launches of the straight run."""
    import train_torch

    t_phase = time.perf_counter()
    tile = raster_v3.TILE if TILE16_DEFAULT else TILE
    kernels = (FWD_KERNELS[tile], BWD_KERNELS[tile])
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-s", scene_dir, *TRAIN_ARGS, "--seed", str(args.seed)]
        probe = TrainProbe(staged_step=TRAIN_STAGED)
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        with probe.installed():
            trainer = train_torch.main(
                argv + ["-m", model1, "--checkpoint_iterations",
                        str(TRAIN_CKPT)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)

        steps = len(probe.events)
        step_ms = probe.step_ms()
        steady = probe.steady_ms()
        losses = torch.stack(probe.losses).cpu().tolist()
        log = trainer.metrics_log
        events = [m for m in log if "densify_grown" in m]
        psnr = {m["iteration"]: m["test_psnr"] for m in log
                if "test_psnr" in m}
        eval_frames = (len(probe.seconds["evaluate"])
                       * (len(trainer.scene.test_cameras())
                          + len(trainer.train_cams[5:30:5])))
        sec = {k: [round(v * 1e3, 1) for v in vals]
               for k, vals in probe.seconds.items()}
        print(f"training from disk ({card}): train_torch.main, "
              f"{steps} steps of mv {MV} at {WIDTH}x{HEIGHT}, "
              f"{run_s * 1e3 / TRAIN_ITERS:.1f} ms/iteration over the run "
              f"(host clock, everything included); by CUDA events "
              f"(densify and eval excluded) the mean step {np.mean(steady):.3f}"
              f" ms over the {len(steady)} steps other than the first and "
              f"the staged one, median {np.median(steady):.3f}; over all "
              f"{steps} steps mean {np.mean(step_ms):.3f}, first "
              f"{step_ms[0]:.3f}, staged {step_ms[TRAIN_STAGED - 1]:.3f}; "
              f"launches {launches}")
        print(f"  densify ms {sec['_cvpm_and_densify']}, graph downsample "
              f"ms {sec['_graph_downsample']}, eval ms {sec['evaluate']} "
              f"({eval_frames} frames), model save ms {sec['save_model']}, "
              f"training-state save ms {sec['save_training_state']}, "
              f"TensorBoard add_image (inside eval) ms "
              f"{sec.get('add_image', 'not installed')}")
        for m in events:
            print(f"  densify @{m['iteration']}: +{m['densify_grown']} "
                  f"-{m['densify_pruned']} (CVPM marked {m['cvpm_marked']}, "
                  f"dropped {m['densify_dropped']}) -> {m['anchors_after']} "
                  f"anchors")
        print(f"  capacity regrowth {probe.grows}; kmax escalations (old, "
              f"new, clipped) {probe.kmax}; test PSNR {psnr}; final "
              f"anchors {int(trainer.mstate.active.sum())}")
        print(f"  step {TRAIN_STAGED}'s stages ms (CUDA events): "
              f"{json.dumps(probe.stages.ms())}")
        print(f"  loss every 10th step "
              f"{json.dumps([round(v, 5) for v in losses[::10]])}")
        if steps != TRAIN_ITERS:
            raise AssertionError(f"{steps} steps for {TRAIN_ITERS} "
                                 "iterations")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError("a training loss is not finite")
        if not events:
            raise AssertionError("no densify call")
        if not probe.grows or probe.grows[0] != (DISK_POINTS,
                                                 2 * DISK_POINTS):
            raise AssertionError(f"capacity regrowth {probe.grows}, not "
                                 f"{DISK_POINTS} -> {2 * DISK_POINTS}")
        if len(probe.seconds["_graph_downsample"]) != 1:
            raise AssertionError("not one graph downsample")
        if not psnr[TRAIN_ITERS] > psnr[1]:
            raise AssertionError(f"test PSNR did not rise: {psnr}")
        want = {kernels[0]: MV * steps + eval_frames, kernels[1]: MV * steps}
        if launches != want:
            raise AssertionError(f"training launched {launches}, not {want}")
        staged_view_checks(probe, tile)
        probe.raster.clear()

        # resume a copy of the iteration-45 checkpoint in a subprocess
        model2 = os.path.join(tmp, "model_resumed")
        os.makedirs(model2)
        for name in (f"chkpnt{TRAIN_CKPT}.npz", f"chkpnt{TRAIN_CKPT}.json",
                     "cfg_args.json"):
            shutil.copy(os.path.join(model1, name), model2)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent
                                 / "train_torch.py"), *argv, "-m", model2,
             "--checkpoint_iterations", str(TRAIN_ITERS),
             "--start_checkpoint",
             os.path.join(model2, f"chkpnt{TRAIN_CKPT}")],
            capture_output=True, text=True, timeout=600)
        resume_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"train_torch.py --start_checkpoint "
                                 f"failed:\n{res.stdout}{res.stderr}")
        pc = os.path.join("point_cloud", f"iteration_{TRAIN_ITERS}")
        with open(os.path.join(model1, pc, "point_cloud.ply"), "rb") as a, \
                open(os.path.join(model2, pc, "point_cloud.ply"), "rb") as b:
            same_ply = a.read() == b.read()
        npz = [read_npz(os.path.join(m, pc, "checkpoints.npz"))
               for m in (model1, model2)]
        same_npz = (sorted(npz[0]) == sorted(npz[1]) and all(
            same_bits(npz[0][k], npz[1][k]) for k in npz[0]))
        want_state = params_to_numpy(trainer._state_tree())
        got_state = read_npz(os.path.join(model2,
                                          f"chkpnt{TRAIN_ITERS}.npz"))
        differ = [k for k in want_state if k not in got_state
                  or not same_bits(want_state[k], got_state[k])]
        same_active = "['active']" not in differ
        print(f"  resumed from chkpnt{TRAIN_CKPT} in a subprocess "
              f"({resume_s:.1f} s): point_cloud/iteration_{TRAIN_ITERS} PLY "
              f"equal {same_ply}, checkpoints.npz equal {same_npz}; final "
              f"training state: {len(want_state)} arrays, {len(differ)} "
              f"differ {differ[:6]}, active mask equal {same_active}")
        if not (same_ply and same_npz and not differ
                and len(got_state) == len(want_state)):
            raise AssertionError("the resumed run differs from the "
                                 "straight one")
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def spatial_ctx_repeats(seed: int, dev):
    """Phase 16's last check: the quick-start model with the context
    grids (use_spatial_ctx), phase 7's trainer at level 2 (all three
    grid levels): two steps from one state are bit-identical."""
    cfg = dataclasses.replace(quickstart_config(), use_spatial_ctx=True)
    pts = np.random.default_rng(seed).normal(size=(65536, 3)).astype(
        np.float32) * 1.2
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(params, state, cfg, seed, dev)
    trainer.rebuild(params, 2)
    trainer.step()
    print(f"use_spatial_ctx (context grids at levels 0-2, ctx_dim "
          f"{4 * cfg.feat_dim}): loss {float(trainer.step()['loss']):.6f}")
    steps_repeat(trainer, seed + 2)


@contextlib.contextmanager
def timed_raft_flows(events: list):
    """eval/raft.py's raft_flow, which make_flow_fn's flows call, wrapped
    for the length of a `with`: CUDA events around each call are appended
    to `events`."""
    inner = raft.raft_flow

    def wrapper(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        stop.record()
        events.append((start, stop))
        return out

    raft.raft_flow = wrapper
    try:
        yield
    finally:
        raft.raft_flow = inner


def eval_phase(args, dev, card: str, scene_dir: str, model_dir: str):
    """Phase 17: phase 16's trained model rendered by render_torch.py,
    scored by metrics_torch.py (held to the CPU view by view) and its
    orbit stream checked by detect_popping_torch.py with RAFT; RAFT held
    to the CPU on a crop.  Returns the forward kernel's launches."""
    import detect_popping_torch
    import metrics_torch
    import render_torch

    t_phase = time.perf_counter()
    name = FWD_KERNELS[raster_v3.TILE if TILE16_DEFAULT else TILE]
    it_dir = f"ours_{TRAIN_ITERS}"

    # 1. the trained model's views through the render CLI
    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    render_torch.main(["-m", model_dir, "-s", scene_dir])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    counts = {(split, kind): len(os.listdir(os.path.join(
        model_dir, split, it_dir, kind)))
        for split in ("train", "test") for kind in ("renders", "gt")}
    want_counts = {("train", "renders"): DISK_VIEWS - 2,
                   ("train", "gt"): DISK_VIEWS - 2,
                   ("test", "renders"): 2, ("test", "gt"): 2}
    if counts != want_counts:
        raise AssertionError(f"render_torch.py wrote {counts}")
    if launches != {name: DISK_VIEWS}:
        raise AssertionError(f"render_torch.py launched {launches} for "
                             f"{DISK_VIEWS} views")

    # 2. the metrics CLI with seeded LPIPS weights at VGG16's widths, each
    # test view recomputed on the CPU from the same PNG pixels
    npz = os.path.join(model_dir, "lpips_random.npz")
    np.savez(npz, **lpips.random_weights(args.seed))
    t0 = time.perf_counter()
    metrics_torch.main(["-m", model_dir, "--lpips_weights", npz])
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - t0
    with open(os.path.join(model_dir, "results.json")) as fh:
        full = json.load(fh)[it_dir]
    with open(os.path.join(model_dir, "per_view.json")) as fh:
        per_view = json.load(fh)[it_dir]
    scores = [v for key in ("PSNR", "SSIM", "FLIP", "LPIPS")
              for v in [full[key], *per_view[key].values()]]
    if not all(v is not None and math.isfinite(v) for v in scores):
        raise AssertionError(f"a metric is not finite: {full}")
    renders, gts, names = metrics_driver.read_images(
        os.path.join(model_dir, "test", it_dir, "renders"),
        os.path.join(model_dir, "test", it_dir, "gt"))
    w_cpu = lpips.load_weights(npz, device="cpu")
    worst = dict.fromkeys(("PSNR", "SSIM", "FLIP", "LPIPS"), 0.0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for r, g, view in zip(renders, gts, names):
            cpu = metrics_driver.view_metrics(torch.from_numpy(r),
                                              torch.from_numpy(g), w_cpu)
            for key in METRIC_TOL:
                worst[key] = max(worst[key],
                                 abs(cpu[key] - per_view[key][view]))
            worst["LPIPS"] = max(worst["LPIPS"], abs(
                per_view["LPIPS"][view] / cpu["LPIPS"] - 1))
    cpu_s = time.perf_counter() - t0
    w_card = lpips.load_weights(npz, device=dev)
    r0, g0 = (torch.from_numpy(x).to(dev) for x in (renders[0], gts[0]))
    with torch.inference_mode():
        metric_ms = {
            "PSNR": cuda_time_ms(lambda: psnr(r0, g0), 3),
            "SSIM": cuda_time_ms(lambda: ssim(r0, g0), 3),
            "FLIP": cuda_time_ms(lambda: ldr_flip(r0, g0), 3),
            "LPIPS": cuda_time_ms(lambda: lpips.lpips(w_card, r0, g0), 3)}
    print(f"eval of the trained model ({card}): render_torch.py "
          f"{render_s:.1f} s ({DISK_VIEWS} views, launches {launches}); "
          f"metrics_torch.py {metrics_s:.1f} s: {json.dumps(full)}; the "
          f"{len(names)} test views recomputed on the CPU ({cpu_s:.1f} s): "
          f"max |d| PSNR {worst['PSNR']:.3e} dB, SSIM {worst['SSIM']:.3e}, "
          f"FLIP {worst['FLIP']:.3e}, LPIPS relative {worst['LPIPS']:.3e}; "
          f"ms per {WIDTH}x{HEIGHT} image on the card (CUDA events, mean "
          f"of 3 after a warm-up) {json.dumps(metric_ms)}")
    for key, tol in METRIC_TOL.items():
        if not worst[key] <= tol:
            raise AssertionError(f"{key}: card and CPU differ by "
                                 f"{worst[key]:.3e} > {tol}")
    if not worst["LPIPS"] <= LPIPS_RTOL:
        raise AssertionError(f"LPIPS: card and CPU differ by "
                             f"{worst['LPIPS']:.3e} relative")

    # 3. an orbit stream of the loaded model, as tools/quality_run.py
    # renders one
    cfg, _, _ = load_run_config(model_dir)
    params, active, contractor, level, _ = load_trained(cfg, device=dev)
    orbit_dir = os.path.join(model_dir, "orbit", "renders")
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else
                      [0.0, 0.0, 0.0], device=dev)
    cuda_lib.LAUNCHES.clear()
    with torch.inference_mode():
        for i in range(ORBIT_FRAMES):
            cam = orbit_camera(i, ORBIT_FRAMES, radius=3.2, height=0.6,
                               width=WIDTH, height_px=HEIGHT, device=dev)
            vis = prefilter_voxel(params["anchors"], active, cam)
            img = render(params, active, contractor, cam, bg,
                         visible_mask=vis, activate_level=level,
                         kmax=cfg.kmax, **decode_kwargs(cfg)).image
            save_png(os.path.join(orbit_dir, f"{i:05d}.png"),
                     img.clamp(0, 1).cpu().numpy())
    orbit_launches = dict(cuda_lib.LAUNCHES)
    if orbit_launches != {name: ORBIT_FRAMES}:
        raise AssertionError(f"the orbit launched {orbit_launches} for "
                             f"{ORBIT_FRAMES} frames")

    # 4. the popping CLI with RAFT: seeded weights in the official layout
    pth = os.path.join(model_dir, "raft_random.pth")
    raft.save_raft_weights(raft.init_raft_params(
        torch.Generator().manual_seed(args.seed), device=dev), pth)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_raft_flows(events):
        pop = detect_popping_torch.main(
            ["--render_dir", orbit_dir, "--flow", "raft", "--weights", pth,
             "--iters", str(RAFT_ITERS),
             "--steps", *(str(k) for k in POPPING_STEPS),
             "--out", os.path.join(model_dir, "popping_results.json")])
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    flow_ms = [a.elapsed_time(b) for a, b in events]
    pairs = {f"step_{k}": ORBIT_FRAMES - k for k in POPPING_STEPS}
    valid = [e["render"]["valid_frac"] for res in pop.values()
             for e in res["frames"]]
    print(f"  detect_popping_torch.py --flow raft ({RAFT_ITERS} iterations)"
          f": {pop_s:.1f} s, {len(flow_ms)} flows at {WIDTH}x{HEIGHT}, "
          f"ms per flow (CUDA events) mean {np.mean(flow_ms):.3f}, min "
          f"{min(flow_ms):.3f}, max {max(flow_ms):.3f}; peak device memory "
          f"{peak_gib:.3f} GiB; valid_frac mean {np.mean(valid):.4f}; "
          f"aggregates "
          f"{json.dumps({k: v['aggregate'] for k, v in pop.items()})}")
    got_pairs = {k: len(v["frames"]) for k, v in pop.items()}
    if got_pairs != pairs or len(flow_ms) != 2 * sum(pairs.values()):
        raise AssertionError(f"frame pairs {got_pairs} ({len(flow_ms)} "
                             f"flows), not {pairs}")
    for res in pop.values():
        if not all(math.isfinite(v) for v in res["aggregate"].values()):
            raise AssertionError(f"a popping aggregate is not finite: "
                                 f"{res['aggregate']}")
    if not all(0.0 <= v <= 1.0 for v in valid):
        raise AssertionError("a valid_frac outside [0, 1]")

    # 5. RAFT card against CPU on the first orbit pair, cropped
    h, w = RAFT_CROP
    a, b = (f[:h, :w] for f in popping.load_frames(orbit_dir, "cpu")[:2])
    params_cpu = raft.load_raft_weights(pth, device="cpu")
    flows = {d: raft.make_flow_fn(params_cpu, iters=RAFT_CHECK_ITERS,
                                  device=d)(a, b).cpu()
             for d in ("cpu", "cuda")}
    scale = max(float(flows["cpu"].abs().max()), 1.0)
    err = float((flows["cuda"] - flows["cpu"]).abs().max())
    print(f"  RAFT on an orbit pair cropped to {w}x{h}, "
          f"{RAFT_CHECK_ITERS} iterations: card vs CPU max |d| {err:.3e} "
          f"(max |flow| {scale:.3f}); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not err <= RAFT_TOL * scale:
        raise AssertionError(f"RAFT: card and CPU differ by {err:.3e}")
    return {name: DISK_VIEWS + ORBIT_FRAMES}


def entry(name, launches, numbers):
    """One kernel's record of the `kernels` line; a kernel with modes
    also lists each mode's numbers."""
    out = {"name": name, "route": "cuda",
           "source": f"splatco_torch/csrc/{name}.cu",
           "replaces": REPLACES[name], "launches": launches,
           "max_abs_err": numbers["err"], "ms": numbers["ms"],
           "plain_ms": numbers["plain_ms"],
           "bound_ms": numbers["bound"][0],
           "bound_by": numbers["bound"][1],
           "library_ms": numbers.get("library_ms")}
    if "modes" in numbers:
        out["modes"] = numbers["modes"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    print(f"built {cuda_lib.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernel checks on a random projected scene
    proj, colors, opac = random_projected_scene(200_000, args.seed, dev)
    cfg = quickstart_config()
    kernel_checks(proj, colors, opac, args.seed, dev, False, cfg.kmax)

    # 4-5. render path at full width
    pts = np.random.default_rng(args.seed).normal(
        size=(65536, 3)).astype(np.float32) * 1.2
    t0 = time.perf_counter()
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    torch.cuda.synchronize()
    n_anchor = int(state.active.sum())
    print(f"model: {n_anchor} anchors x {cfg.n_offsets} offsets, plane "
          f"levels {[g['xy'].shape[-1] for g in params['planes']['grids']]}"
          f", init {time.perf_counter() - t0:.1f} s")
    cams = orbit_cameras(args.frames, dev)
    level = 2
    fwd = render_phase(params, state, cfg, cams, level, dev, False)

    # 6. small model card vs CPU
    small_model_agrees(args.seed, dev)

    # 7-8. training at full width, the backward kernel at a training view
    trainer, train_launches, _ = train_phase(params, state, cfg, args, dev)
    bwd = backward_at_view(trainer)

    # 9. determinism, 10. small model step card vs CPU
    steps_repeat(trainer, args.seed + 1)
    small_step_agrees(args.seed, dev)
    del trainer

    # 11-13. the v3 configuration: kernel checks, render, training
    cfg3 = dataclasses.replace(cfg, kmax=KMAX_V3)
    kernel_checks(proj, colors, opac, args.seed, dev, True, cfg3.kmax)
    del proj, colors, opac
    fwd3 = render_phase(params, state, cfg3, cams, level, dev, True)
    trainer3, train3_launches, _ = train_phase(params, state, cfg3, args,
                                               dev, tile16=True)
    bwd3 = backward_at_view(trainer3)
    steps_repeat(trainer3, args.seed + 1)
    del trainer3

    # 14. the probes and the ablation through their tools
    probe_launches, probe_numbers = probe_phase(dev)

    with tempfile.TemporaryDirectory() as tmp:
        scene_dir = write_scene(tmp, args, dev)
        # 15. a scene on disk: read, saved, rendered by render_sets and by
        # render_torch.py
        disk_launches = disk_phase(args, dev, smi, scene_dir)
        # 16. trained on it by train_torch.py, resumed in a subprocess
        model_dir = os.path.join(tmp, "trained")
        train_disk_launches = train_disk_phase(args, dev, smi, scene_dir,
                                               model_dir)
        spatial_ctx_repeats(args.seed, dev)
        # 17. the trained model rendered, scored and its orbit stream
        # checked for popping through the CLIs
        eval_launches = eval_phase(args, dev, smi, scene_dir, model_dir)

    print(json.dumps({"kernels": [
        entry(KERNEL, fwd["launches"].get(KERNEL, 0)
              + train_launches.get(KERNEL, 0)
              + disk_launches.get(KERNEL, 0)
              + train_disk_launches.get(KERNEL, 0)
              + eval_launches.get(KERNEL, 0), fwd),
        entry(BWD_KERNEL, train_launches.get(BWD_KERNEL, 0)
              + train_disk_launches.get(BWD_KERNEL, 0), bwd),
        entry(KERNEL16, fwd3["launches"].get(KERNEL16, 0)
              + train3_launches.get(KERNEL16, 0)
              + disk_launches.get(KERNEL16, 0)
              + train_disk_launches.get(KERNEL16, 0)
              + eval_launches.get(KERNEL16, 0), fwd3),
        entry(BWD_KERNEL16, train3_launches.get(BWD_KERNEL16, 0)
              + train_disk_launches.get(BWD_KERNEL16, 0), bwd3),
        *(entry(name, probe_launches[name], nums)
          for name, nums in probe_numbers.items()),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
