#!/usr/bin/env python3
"""Drive the splatco_torch render and training paths on one NVIDIA card, in
both rasterizer configurations (32 px tiles, v2; 16 px tiles, v3), and
the sharded training step, and hold each CUDA kernel against its plain
PyTorch version.

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
     (the row sums in every mode bit for bit on the tool's windows, edge
     windows, windows below 0 and at or past the width, one window, rows
     not 16 B aligned and the kernel scale's 8,192 windows; the cumsum
     on the tool's xs, xs with inf, -inf and NaN rows, seeded shapes and
     a misaligned x, fp32 bit for bit, NaN where the plain version is
     NaN, TF32 with NaN and inf at the plain version's positions and
     within 5e-4 of a float64 cumsum's max elsewhere; both kernels timed
     at kernel scale too, the cumsum at [128, 65,536] beside
     torch.cumsum; the ablation's full / nostage / noaccum to the
     forward's bound; the accumulation bit for bit and in place on
     seeded views of 1 to 2^20 floats that start 0-3 floats into larger
     buffers, at 0, 1, 4 and 5 steps, and refusing views that overlap;
     the alpha-sum probe bit for bit,
     NaN where it is NaN, on the tool's inputs (inf and NaN sums), with
     row 2 made positive, and on windows at the edges, below 0 and past
     the width), the plain versions and the one-call library versions
     (torch.cumsum, Tensor.add_) timed, the accumulation, add_ and an
     empty launch (the launch floor) timed in turns, each kernel's
     bound, the alpha-sum probe's with the exps on the special-function
     unit at the SM's maximum clock (nvidia-smi).
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
 18. the sharded SVC step (splatco_torch/parallel) on the card.  18a: in
     this process, a 1x1 mesh over NCCL (world size 1): phase 4's model,
     one sharded step on orbit view 0 at q = 0 against
     make_train_step(mv=1) from the same state (loss, first moments and
     every param element within the limits stated at SHARDED_ONE_*), both
     timed.  18b: four ranks of this script (--sharded-rank, started by
     torchrun) share the card over gloo on CUDA tensors as a 2x2 mesh,
     the same model with its offsets untied (parallel/dryrun.untie_
     offsets) at full width (orbit views 0-1, strips of 544 px): which
     collectives gloo takes on CUDA tensors; a first step held to the
     single-device mv = 2 step (num_clipped per strip printed), two
     timed steps (ms/step per rank: four processes on one card, not a
     multi-card figure), one step with the collectives traced (ms and
     bytes per collective), then two steps from one state; the
     replicated params must be bit-identical on the four ranks after
     every step and the repeated step bit for bit on every rank, and each
     rank launches each blend kernel once a step; then one step from the
     same state in 16 px tiles (SPLATCO_RASTER=v3's configuration, kmax
     32), held the same way to the single-device v3 step.  18c: the same
     ranks at 64x64 on tests/test_parallel.py's model size: the kernel
     path's gradients against dense under the sharded step, in 16 px
     tiles the sharded step's gradients against the single-device step's
     (offsets untied; tied printed), and the sharded loop (24 steps, two
     densify calls, a capacity regrowth, a level bump) against the
     single-device trajectory rank 0 runs beside it; only the sharded
     steps' launches count.
 19. the last user paths, on phase 16's run.  19a: `train_torch.main
     --gui` resumes a copy of its iteration-45 state for 20 iterations
     while a client thread speaks SIBR messages at 1600x1088: frames
     while it trains, `train=False` must hold the iteration for 0.5 s,
     paused frames at scaling_modifier 1 and 0.5 must equal the port's
     `render` of the published snapshot byte for byte (and differ), a
     zero-resolution message returns only the verify string, and with
     `keep_alive` the server answers after the last iteration until the
     client leaves; ms per served frame (host clock, send to last byte);
     `raster_fwd` launches 4 a step + 1 an eval frame + 1 a served frame.
     19b: `--profile` over 5 iterations of the same run: the Chrome trace
     must name both blend kernels and the `plane_sample` ranges.  19c:
     tools/profile_step_recon_torch.py on phase 7's model and views:
     ms/step of each variant and each block's cost; the step without the optimizer returns its params
     bit for bit.  19d: the hard protocol's scene (28 views at 320x224,
     arc_period 2; no ground-truth view may clip), a 600-iteration
     `quality_run_torch.main --hard` (finite losses, test PSNR rising;
     each densify call's grown / pruned / CVPM-marked anchors printed),
     `ablation_run_torch.main` at 200 iterations (four finite variants)
     and `finalize_quality_run_torch.main` on the run's last checkpoint
     (the run's final metrics).
 20. the tri-plane sampler (ops/plane_sample.py), whose kernels every
     decode above launched (`plane_sample_fwd` once a plane of a decode;
     `plane_sample_bwd` once a plane of a training step; counted exactly
     in phases 4, 7, 12, 13 and 17's orbit, at least once in the
     others).  20a: at full width (131,072 rows, R 5, planes of 700^2
     and 1400^2; a quarter of the rows inside, a quarter partly off the
     plane, half at one point), and at 700^2 with every row at one cell
     and every |g| at the top of its binade, the forward and the
     backward's three gradients equal their plain versions bit for bit,
     and two backward launches agree bit for bit.  20b: each timed
     beside its bound, its plain version and `F.grid_sample` (forward;
     its backward, `grid_sampler_2d_backward`); the backward's passes and
     the kernels of one sampled plane's forward and backward by
     torch.profiler, beside the kernels of the stable sort the sampler
     needed before its backward summed integers.
     20c: phase 16's iteration-45 state (capacity 131,072): the
     sampler's forward + backward over level 0's 6 planes and all 12,
     through the plain version with autograd (`index_put_`, the path
     before these kernels) and through the kernels, over all rows and
     over the active ones alone.
 21. the tile binning (ops/binning.py: bin_count, bin_place,
     bin_sort_tiles) and the backward's slot reduce (ops/rasterize.py:
     slot_reduce), whose kernels every rasterize above launched (each
     binning kernel once a blend forward, the reduce once a blend
     backward: `check_binning` in every phase, 21d's table at the end).
     21a: each kernel launched twice against its plain version, bit for
     bit (bin_place as each segment's keys: its atomics choose their
     order, which the sort undoes), and the composed binning against the
     plain one, on the inputs the main path gave `bin_frame` at frame 0
     of the quick-start model (v2 at kmax 12, v3 at kmax 32), at phase
     16's iteration-45 state (capacity 131,072, padding rows included,
     kmax 32) and on a crafted tile of HOT_N gaussians (longer than a
     sorting block's shared memory), in v2 and v3; untimed, on a crafted
     tile of LONG_N gaussians (merged in more than one round), on crafted
     warps that mix rects clipped to kmax with radius-0 rows (MIXED_N
     rows, not a multiple of 32; v2 at kmax 12, v3 at kmax 40, whose
     gaussians' slots span more than one round of 32), and at frame 0 on
     wide grids, one of them past binning.SHARED_TILES (where bin_count
     counts in global memory).  The sort's outputs are
     compared by `binning.binning_diff`: the slot mask bit for bit, the
     slot map only under it (the card leaves it unfilled elsewhere).
     21b: each timed beside its bound (bytes, or the reach test's fp32
     operations; the sort's and the reduce's also beside the bound they
     had when the slot map was dense), its plain version and the one
     library call of the same function (`torch.argsort(stable=True)` for
     the sort, `index_add_` for the reduce; timed, never used), and each
     kernel's device operations by torch.profiler.  21c:
     frame 0's binning stage with the kernels and with the plain
     versions, in turns.
 22. SSIM (ops/losses.py: sep_blur, ssim_map_fwd, ssim_map_bwd), whose
     kernels every training step, eval and metric above launched (a
     forward blurs and maps once, a backward maps back and blurs once:
     `check_ssim` in every phase, exactly where the count is simple, 0
     in the render-only ones).  22a-c: on a training view's images at
     1600x1088, phase 17's first test view (its render and ground truth
     as read back from the PNGs render_torch.py wrote), sizes that are
     no multiple of the blur's tiles (B = 2; the blur also at 1, 3 and 31
     taps), H or W below the 11-tap window, a 1x1 image and NaN and
     infinite pixels, each kernel launched twice against its plain
     version bit for bit (the map's backward with a seeded cotangent and
     with a constant one, as `mean` sends), and `ssim` and `masked_ssim` with their
     gradients through the kernels against the same calls through the
     plain versions on the card, bit for bit; each kernel timed at a
     training view's shapes beside its bound, its plain version and, for
     the blur, a depthwise `F.conv2d` pair (timed, never used).  22d:
     the three kernels' launches on each phase's main path.
 23. the EWA projection (ops/projection.py: project_fwd, project_bwd),
     whose kernels every render and training step above launched
     (`project_fwd` once a prefilter, radius only, and once a render;
     `project_bwd` once a render's backward: `check_projection` in every
     phase, exactly where the count is simple).  23a: each kernel launched
     twice against its plain version bit for bit (the forward full and
     radius only; the backward with the cotangents given and with zero
     ones, none and seeded ones zeroed on the culled rows, as a step
     sends them), on frame 0's decoded gaussians of the quick-start
     model (v2 and v3 decode the same), a training step's view with the
     cotangents the step sent back, phase 16's iteration-45 state
     (capacity 131,072, its padding rows included), the prefilter's
     anchors (the quick-start model's and that state's, the base scales
     a strided slice), crafted rows (`projection_crafted_cases`: behind
     and on the near plane, |tz| < 1e-8, a zero quaternion, zero scales,
     NaN and infinite inputs, tx / tz and ty / tz exactly at the frustum
     limits, det == 0 under a singular view) and seeded rows at ragged
     sizes, contiguous and as views 1 and 3 rows into larger tensors
     (`projection_ragged_cases`: bases 4 and 12 B past 16 B).  23b: each
     kernel timed at
     phase 16's state, frame 0 and the step's view beside its bound and
     its plain version (no one PyTorch call computes it), the radius-only
     launch also at the prefilter's sizes.  23c: the two kernels'
     launches on each phase's main path.
 24. the inference decode's CUDA graph (models/decode_graph.py): phase
     4's orbit rendered eagerly (autograd on, where the graph declines)
     and replayed (inference mode), twice each way, the 8-bit frames
     equal; ms a frame each way and the graph's pool.
Kernel times are splatco_torch.utils.measure.cuda_time_ms's.
Prints a `kernels` JSON line (all twenty kernels), then, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero and prints no result when
there is no CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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
from splatco_torch.data.cameras import look_at_camera, projection_matrix
from splatco_torch.data.images import save_png
from splatco_torch.data.scene import Scene
from splatco_torch.eval import metrics_driver, popping, raft
from splatco_torch.eval.render_driver import (load_trained, render_set,
                                              render_sets)
from splatco_torch.models import decode_graph
from splatco_torch.models.contraction import Contractor
from splatco_torch.models.renderer import (anchor_plane_coords,
                                           generate_neural_gaussians,
                                           prefilter_voxel, render)
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.models.triplane import _split_coords, apply_tpa
from splatco_torch.ops import (binning, cuda_lib, lpips, plane_sample,
                               probes, raster_ablate, raster_v3)
from splatco_torch.ops import losses as loss_ops
from splatco_torch.ops import projection as projection_ops
from splatco_torch.ops import rasterize as rasterize_ops
from splatco_torch.ops.binning import TILE
from splatco_torch.ops.flip import ldr_flip
from splatco_torch.ops.losses import l1_loss, masked_ssim, psnr, ssim
from splatco_torch.ops.projection import ProjectedCols, project_gaussians_cols
from splatco_torch.ops.rasterize import (REDUCE_KERNEL, TILE16_DEFAULT,
                                         bin_frame, reduce_slots,
                                         reduce_slots_plain, tile_grid)
from splatco_torch.ops.rasterize_cuda import (BWD_KERNEL, BWD_KERNELS,
                                              FWD_KERNELS, KERNEL,
                                              bwd_cull_mask, fwd_cull_mask,
                                              raster_bwd, raster_bwd_plain,
                                              raster_fwd, raster_fwd_plain)
from splatco_torch.parallel import collectives, distributed
from splatco_torch.parallel.dryrun import (sharded_loop, single_gradients,
                                           step_gradients, untie_offsets)
from splatco_torch.parallel.mesh import STAT_FIELDS, shard_params
from splatco_torch.parallel.train_step import make_sharded_train_step
from splatco_torch.train import loop as train_loop
from splatco_torch.train.checkpoint import (load_train_state,
                                            params_to_numpy,
                                            save_model_checkpoint)
from splatco_torch.train.optimizer import (group_schedules, label_params,
                                           make_optimizer)
from splatco_torch.train.step import init_stats, make_train_step
from splatco_torch.utils.math import normalize, round_up
from splatco_torch.utils.measure import (PEAK_FP32_PER_S, PEAK_TF32_PER_S,
                                         SFU_PER_CLOCK_SM, SM_COUNT, bound,
                                         bound_terms, bwd_bound, cuda_time_ms,
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
    # the tri-plane sampler: an XLA stage (the gather of `_sample_plane`;
    # the backward is its jax.grad scatter-add), not a Pallas kernel
    plane_sample.FWD_KERNEL: "splatco_tpu/models/triplane.py:51",
    plane_sample.BWD_KERNEL: "splatco_tpu/models/triplane.py:51",
    # the tile binning and the backward's reduce: XLA stages (sorts,
    # gathers, a segment sum), not Pallas kernels
    binning.COUNT_KERNEL: "splatco_tpu/ops/binning.py:210",
    binning.PLACE_KERNEL: "splatco_tpu/ops/binning.py:277",
    binning.SORT_KERNEL: "splatco_tpu/ops/binning.py:300",
    REDUCE_KERNEL: "splatco_tpu/ops/rasterize.py:140",
    # SSIM: the blur of `_sep_gauss_blur` and its custom VJP, and the
    # map's elementwise tail and its jax.grad, all XLA
    loss_ops.BLUR_KERNEL: "splatco_tpu/ops/losses.py:55",
    loss_ops.MAP_FWD_KERNEL: "splatco_tpu/ops/losses.py:109",
    loss_ops.MAP_BWD_KERNEL: "splatco_tpu/ops/losses.py:109",
    # the EWA projection: `covariance_cols` + `project_cols` and their
    # jax.grad, all XLA
    projection_ops.FWD_KERNEL: "splatco_tpu/ops/projection.py:170",
    projection_ops.BWD_KERNEL: "splatco_tpu/ops/projection.py:170",
}
SAMPLER = (plane_sample.FWD_KERNEL, plane_sample.BWD_KERNEL)
BINNING = (*binning.KERNELS, REDUCE_KERNEL)
SSIM = loss_ops.KERNELS
PROJECTION = projection_ops.KERNELS
XLA_STAGES = (*SAMPLER, *BINNING, *SSIM, *PROJECTION)
# phase 14: the tools time each probe mode and ablation variant over this
# many launches, after one checked launch and a warm-up
PROBE_ITERS = 20
# the fp32 cumsum adds in the plain version's order: held to it bit for
# bit, NaN where it is NaN; the TF32 one rounds each input to 10 mantissa
# bits and sums on the tensor cores: NaN and +-inf at the plain version's
# positions, elsewhere held to 5e-4 of the max of a float64 cumsum: above
# TF32's measured 1.9e-4, below the ~1.5e-3 of inputs rounded to bf16
CUMSUM_TF32_TOL = 5e-4
# the kernel scale both window probes are also checked and timed at: the
# cumsum over [128, CUMSUM_SCALE_COLS] (32 MiB in, 32 MiB out), the
# extraction on the tool's 8,192 `big` / `st2` windows
CUMSUM_SCALE_COLS = 65536
# the accumulation probe held bit for bit on seeded views of these sizes
# that start (out, in) floats into larger buffers (equal offsets take
# the 16 B path after a head, unequal ones go element by element), at
# these step counts; then the kernel, add_ and an empty launch timed in
# PROBE_TURNS turns, as the window probes at kernel scale are
ACCUM_SIZES = (1, 3, 1023, 1024, 1025, 1 << 20)
ACCUM_OFFSETS = ((0, 0), (1, 1), (2, 2), (3, 3), (1, 0), (2, 3))
ACCUM_STEP_COUNTS = (0, 1, 4, 5)
PROBE_TURNS = 5
# the alpha-sum probe repeats its plain version's float32 operations in
# order, and both take libdevice's expf (torch's CUDA exp): held to it
# bit for bit, NaN where it is NaN
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
# phase 18a: the 1x1 sharded step against the single-device step from one
# state, each timed over this many steps.  Loss to 1e-5 relative (mean vs
# sum / npix, ssim vs masked_ssim: the same terms rounded in other
# orders); the first moments (0.1 x the gradient) to 1e-5 of each leaf's
# max; a param element may differ by at most 2 lr, since Adam's first
# update is lr * m / sqrt(v), |m / sqrt(v)| <= 1, and a gradient at
# rounding level may change its sign
SHARDED_ONE_ITERS = 3
SHARDED_ONE_LOSS_TOL, SHARDED_ONE_MU_TOL = 1e-5, 1e-5
# phase 18b: 2 views x 2 strips (544 px) in four ranks on the card: one
# step, SHARDED_TIMED timed, one traced, two from one state, and one in
# 16 px tiles.  The first loss against the single-device mv = 2 step:
# 1e-5 relative where nothing clips (the same records, summed in other
# orders: the offsets are untied, so no two of a tile's records share a
# depth, whose order would follow each gaussian's slot rank in its
# frame); where a strip or view clips, each strip clips its own rects
# around centres in its own frame, so 5e-3, the loop's limit
SHARDED_MESH, SHARDED_TIMED, SHARDED_RANK_TIMEOUT = (2, 2), 2, 600
SHARDED_LOSS_TOL, SHARDED_LOSS_TOL_CLIPPED = 1e-5, 5e-3
# phase 18c, at this size: the kernel path's gradients against dense under
# the sharded step, max-normalised per leaf to 5e-4 (the JAX kernel
# backward's bound against the dense oracle); in 16 px tiles, with the
# offsets untied, the sharded step's gradients against the single-device
# step's to 1e-5 of each leaf's max (the same kernels on the same
# records; the slot sums reorder as a strip's clamped rects move each
# gaussian's slots; 1e-5 is the backward kernel's own limit against its
# plain version) and its loss to 1e-5; the sharded loop's losses to 5e-3
# of the single-device trajectory (dryrun_multichip's limit)
SMALL_SHARDED, SHARDED_GRAD_TOL, LOOP_TOL = (64, 64), 5e-4, 5e-3
SHARDED16_GRAD_TOL = 1e-5
# phase 19a: --gui resumes phase 16's chkpnt45 for 20 iterations; the
# client pauses the run once it has published iteration 48.  19b:
# --profile over 5 iterations from the same state.  19c: each variant of
# the step attribution timed over this many steps.  19d: the hard
# protocol's scene (the quality run's defaults, arc_period 2), its
# quality run and the ablation's runs
VIEWER_ITERS, VIEWER_PAUSE_AT, PROFILE_ITERS = 65, 48, 50
RECON_ITERS = 6
HARD_VIEWS, HARD_POINTS, HARD_W, HARD_H = 28, 1200, 320, 224
HARD_ITERS, ABLATION_ITERS = 600, 200
# phase 20: the tri-plane sampler's kernels at full width (a trained
# model's capacity after its regrowth, the quick start's R = 15 // 3 and
# plane sizes), and every row at one cell with every |g| at the top of
# its binade (the integer sums' largest).  The forward and all three
# gradients are held to their plain versions bit for bit (the same
# float32 operations, --fmad=false, and the same int64 sums), and two
# backward launches to each other
SAMPLER_ROWS, SAMPLER_R, SAMPLER_SIZES = 131072, 5, (700, 1400)
SAMPLER_ITERS = 20
# phase 21: the binning kernels and the slot reduce, each held to its plain
# version bit for bit (bin_place up to the order within a segment, which
# its atomics choose and bin_sort_tiles undoes) and timed over BIN_ITERS
# launches; the crafted scene's HOT_N gaussians all lie in one tile, a
# segment longer than the 4,096 keys a sorting block holds, and LONG_N
# (untimed) make 18 such chunks, merged in five rounds.  The bounds
# count the reach test's fp32 operations: a gaussian's rect and conic
# terms (two divisions, a log) and each slot of its clipped rect tested
# (four edges of clamps, products and sums, the minima, the compares)
BIN_ITERS, HOT_N, LONG_N = 20, 30000, 70000
# frame 0 on wide grids: 32,400 and 32,640 tiles, which bin_count counts in
# shared memory, and 129,600 (7680x4320 in 16 px tiles), past
# binning.SHARED_TILES, which it counts in global memory
WIDE_FRAMES = ((7680, 4320, False), (3840, 2160, True), (7680, 4320, True))
# the crafted mixed warps' rows (not a multiple of 32) and v3's kmax there
# (slots of one gaussian over more than one round of 32)
MIXED_N, MIXED_KMAX_V3 = 4133, 40
OPS_PER_GAUSSIAN, OPS_PER_SLOT = 40, 60
# phase 22: SSIM's kernels held to their plain versions bit for bit (the
# same float32 operations in the same order, --fmad=false, IEEE division)
# on a training view's moments, phase 17's first test view (render and
# ground truth read back from their PNGs; its shape comes with it), sizes that are no multiple of the blur's 246 x 64 tiles (with B = 2,
# and the blur at other windows too), H or W below the 11-tap window, a
# 1x1 image and NaN and infinite pixels; each kernel timed over
# SSIM_ITERS launches and its plain version over SSIM_PLAIN_ITERS.  The
# bounds count the map's fp32 operations a pixel (csrc/ssim.cuh: 17 in
# `map`, 38 in `map_vjp`, a division as one) and the blur's multiplies
# and adds (2 (2 taps - 1) a pixel)
SSIM_CASES = (("a training view", (1, 3, HEIGHT, WIDTH), None),
              ("phase 17's first test view", None, "png"),
              ("odd sizes", (2, 3, 1001, 1517), None),
              ("H < 11", (1, 3, 7, 300), None),
              ("W < 11", (1, 3, 300, 6), None),
              ("1x1", (1, 3, 1, 1), None),
              ("NaN and inf pixels", (1, 3, 257, 333), "nonfinite"))
BLUR_WINDOWS = (1, 3, 31)
SSIM_ITERS, SSIM_PLAIN_ITERS = 20, 3
SSIM_FWD_OPS, SSIM_BWD_OPS = 17, 38
# phase 23: the EWA projection's kernels held to their plain versions bit
# for bit (the same float32 operations in the same order, --fmad=false,
# IEEE division and square root) on frame 0's decoded gaussians (v2 and
# v3 decode the same), a training step's view 0 with the cotangents the
# step sent back, phase 16's iteration-45 state (capacity 131,072, its
# padding rows included), the prefilter's anchors (the quick-start
# model's and that state's) and crafted rows (`projection_crafted_cases`:
# every degenerate case, NaN and inf included); the backward also with
# zero cotangents and with none.  Each kernel timed over PROJ_ITERS
# launches and its plain version over PROJ_PLAIN_ITERS.  The bounds count
# 40 B of inputs a gaussian, 28 B of outputs (4 B radius only), 4 B a
# cotangent sent and 40 B of gradients, and the plain versions'
# elementwise operations a gaussian (torch.profiler counts 300 aten ops
# in the forward, 721 in the backward, which recomputes the forward;
# each one float32 or boolean operation a row)
PROJ_ITERS, PROJ_PLAIN_ITERS = 20, 3
PROJ_FWD_OPS, PROJ_BWD_OPS = 300, 721


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


def grid(tile16: bool, height: int = HEIGHT, width: int = WIDTH):
    """(tiles_x, tiles_y) of the configuration at width x height."""
    return (raster_v3.tile_grid if tile16 else tile_grid)(height, width)


def tile_of(tile16: bool) -> int:
    return raster_v3.TILE if tile16 else TILE


def blend_launches(launches: dict) -> dict:
    """The blend kernels' part of a run's launches (the tri-plane
    sampler's part is held by `check_sampler`, the binning's by
    `check_binning`, SSIM's by `check_ssim`)."""
    return {k: v for k, v in launches.items() if k not in XLA_STAGES}


def check_binning(launches: dict, what: str):
    """Every rasterize bins once before its blend forward and reduces
    once after its blend backward: each binning kernel launched as often
    as the forward blend kernels, the slot reduce as often as the
    backward ones, and the forward at least once."""
    fwd = sum(launches.get(k, 0) for k in FWD_KERNELS.values())
    bwd = sum(launches.get(k, 0) for k in BWD_KERNELS.values())
    want = {**{k: fwd for k in binning.KERNELS}, REDUCE_KERNEL: bwd}
    got = {k: launches.get(k, 0) for k in BINNING}
    if got != want or not fwd:
        raise AssertionError(f"{what} launched the binning kernels {got} "
                             f"times, not {want}")


def planes_sampled(level: int) -> int:
    """Planes one decode samples at `level`: three a level, and level 0's
    three TPA-modulated planes."""
    return 3 * (level + 1) + 3


def check_sampler(launches: dict, what: str, fwd=None, bwd=None):
    """The sampler's kernels launched exactly `fwd` and `bwd` times in
    `what`, or at least once where the count is None."""
    got = tuple(launches.get(k, 0) for k in SAMPLER)
    if not all(g >= 1 if w is None else g == w
               for g, w in zip(got, (fwd, bwd))):
        raise AssertionError(f"{what} launched the sampler's kernels "
                             f"{got} times, not {(fwd, bwd)} (None: at "
                             "least once)")


def check_ssim(launches: dict, what: str, fwd=None, bwd=None):
    """SSIM's kernels launched for `fwd` forwards and `bwd` backwards in
    `what`, or at least once each where the count is None: a forward
    blurs once and maps once, a backward maps back once and blurs once,
    so the blur always launches as often as the two map kernels
    together."""
    got = {k: launches.get(k, 0) for k in SSIM}
    n_fwd, n_bwd = got[loss_ops.MAP_FWD_KERNEL], got[loss_ops.MAP_BWD_KERNEL]
    if not (got[loss_ops.BLUR_KERNEL] == n_fwd + n_bwd
            and all(n >= 1 if w is None else n == w
                    for n, w in ((n_fwd, fwd), (n_bwd, bwd)))):
        raise AssertionError(f"{what} launched SSIM's kernels {got} times, "
                             f"not for {(fwd, bwd)} forwards and backwards "
                             "(None: at least once)")


def check_projection(launches: dict, what: str, fwd=None, bwd=None):
    """The projection's kernels launched exactly `fwd` and `bwd` times in
    `what`, or at least once where the count is None: `project_fwd` once
    a prefilter (radius only) and once a render, `project_bwd` once a
    render's backward."""
    got = tuple(launches.get(k, 0) for k in PROJECTION)
    if not all(g >= 1 if w is None else g == w
               for g, w in zip(got, (fwd, bwd))):
        raise AssertionError(f"{what} launched the projection's kernels "
                             f"{got} times, not {(fwd, bwd)} (None: at "
                             "least once)")


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


def orbit_cameras(n: int, dev: torch.device, width: int = WIDTH,
                  height: int = HEIGHT):
    return [look_at_camera([3.5 * math.sin(2 * math.pi * i / n), 0.4,
                            -3.5 * math.cos(2 * math.pi * i / n)],
                           [0, 0, 0], [0, -1, 0], 1.2, 1.2 * height / width,
                           width, height, uid=i, device=dev)
            for i in range(n)]


def frame_stages(params, state, cam, cfg, level, tile16=False,
                 plain_binning=False):
    """One frame's stages as render() runs them in the configuration, each
    timed with CUDA events (and named for torch.profiler); returns (binned
    records, {stage: ms}).  `plain_binning` bins through the binning
    kernels' plain versions instead of the kernels."""
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
        if plain_binning:
            binned = binning.bin_gaussians_plain(
                proj, g["color"], g["opacity"], tile_of(tile16), tiles_x,
                tiles_y, cfg.kmax, tile16)
        else:
            binned = bin_frame(proj, g["color"], g["opacity"],
                               tile_of(tile16), HEIGHT, WIDTH, cfg.kmax)[0]
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
    if blend_launches(launches) != {k: MV * n_steps for k in kernels}:
        raise AssertionError(f"training launched {launches} for {n_steps} "
                             f"steps of {MV} views: each of {kernels} "
                             f"{MV * n_steps} times, nothing else")
    # one sampling of the planes a step, shared by its views
    planes = planes_sampled(0) * (n_steps - 2) + planes_sampled(2) * 2
    check_sampler(launches, "training", planes, planes)
    check_binning(launches, "training")
    # an SSIM a view (forward and backward) and one a consistency pair's
    # gate (forward; the step computes the gates when none are passed)
    check_ssim(launches, "training", n_steps * (MV + MV * (MV - 1) // 2),
               n_steps * MV)
    # a view: the prefilter's and the render's forward, one backward
    check_projection(launches, "training", 2 * MV * n_steps, MV * n_steps)
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
    if blend_launches(launches) != {name: frames}:
        raise AssertionError(f"render_set launched {launches} for {frames} "
                             "frames")
    check_sampler(launches, "render_set", frames * planes_sampled(level), 0)
    check_binning(launches, "render_set")
    check_ssim(launches, "render_set", 0, 0)
    check_projection(launches, "render_set", 2 * frames, 0)

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


def decode_graph_phase(params, state, cfg, cams, level: int):
    """Phase 24: the orbit rendered eagerly (autograd on: the decode's
    graph declines) and replayed (inference mode), twice each way, each
    replayed 8-bit frame equal to the eager one; ms a frame each way (the
    host clock over a pass, synchronized), the decodes counted and the
    device memory of the graph's pool."""
    def frames(grad: bool):
        mode = torch.enable_grad() if grad else torch.inference_mode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode:
            out = []
            for cam in cams:
                vis = prefilter_voxel(params["anchors"], state.active, cam)
                img = render(params, state.active, state.contractor, cam,
                             torch.zeros(3, device=cam.camera_center.device),
                             visible_mask=vis, activate_level=level,
                             kmax=cfg.kmax, **decode_kwargs(cfg)).image
                out.append((img.clamp(0.0, 1.0) * 255.0).to(torch.uint8))
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / len(cams)

    before = dict(decode_graph.STATS)
    passes = [frames(grad) for grad in (True, False, True, False)]
    counted = {k: decode_graph.STATS[k] - before.get(k, 0)
               for k in ("eager", "captures", "replays")}
    graph = decode_graph._graph
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if graph is not None
               and tuple(seg["segment_pool_id"]) == tuple(graph.graph.pool()))
    print(f"decode graph: ms a frame eager / replayed "
          f"{passes[0][1]:.3f} / {passes[1][1]:.3f}, "
          f"{passes[2][1]:.3f} / {passes[3][1]:.3f}; decodes {counted}; "
          f"the graph's pool {pool / 2**20:.1f} MiB")
    for eager, replayed in ((passes[0][0], passes[1][0]),
                            (passes[2][0], passes[3][0])):
        for i, (a, b) in enumerate(zip(eager, replayed)):
            if not torch.equal(a, b):
                raise AssertionError(f"frame {i}: the replayed decode's "
                                     "8-bit image differs from the eager one")
    if counted["replays"] < len(cams):
        raise AssertionError(f"the orbit replayed {counted['replays']} of "
                             f"{2 * len(cams)} decodes")
    print(f"decode graph: {2 * len(cams)} replayed frames equal the eager "
          "ones")


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


def accum_case(n: int, offsets, seed: int, dev):
    """Seeded views (out, in) of n floats that start offsets[0] and
    offsets[1] floats into buffers 8 floats longer."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=n + 8).astype(np.float32),
                                 device=dev)[o:o + n] for o in offsets)


def accum_differs(out, inp, steps: int) -> list:
    """What `probes.accumulate_(out, inp, steps)` changes that the plain
    version does not: the view's bits, the buffer around the view, or
    the buffer itself (not in place)."""
    base, lo = out._base, out.storage_offset()
    hi = lo + out.numel()
    before = base.clone()
    want = probes.accumulate_plain_(out.clone(), inp, steps)
    ptr = out.data_ptr()
    got = probes.accumulate_(out, inp, steps)
    bad = [] if got.data_ptr() == ptr else ["not in place"]
    if not same_floats(out, want):
        bad.append("bits")
    if not (same_floats(base[:lo], before[:lo])
            and same_floats(base[hi:], before[hi:])):
        bad.append("outside the view")
    return bad


def accum_overlaps(dev) -> list:
    """(out, inp) pairs whose bytes overlap, which `accumulate_` refuses:
    one buffer twice, views one float apart, and a view inside another."""
    x = torch.ones(1024, device=dev)
    return [(x, x), (x[1:], x[:-1]), (x[:-1], x[1:]),
            (x[:512], x[256:768])]


def blend_cases(inp: dict, dev) -> dict:
    """{case: (data, starts)} for the alpha-sum probe: the tool's inputs
    (inf and NaN sums) and with row 2 made positive; seeded [16, 8320]
    data (row 2 made positive) at windows with p % 128 = 0 / 127, the
    last that fits, below 0 and at or past the width (columns outside
    read 0), and one window alone."""
    big = torch.as_tensor(inp["big"], device=dev)
    pos = big.clone()
    pos[2] = pos[2].abs()
    st2 = torch.as_tensor(inp["st2"], device=dev)
    data = torch.as_tensor(np.random.default_rng(1).normal(
        size=(probes.REC, 8320)).astype(np.float32), device=dev)
    data[2] = data[2].abs()
    w = data.shape[1]

    def starts(*p):
        return torch.tensor(p, dtype=torch.int32, device=dev)
    return {
        "the tool's inputs": (big, st2),
        "the tool's inputs, |row 2|": (pos, st2),
        "edge windows": (data, starts(0, 7, 127, 128, 255, 1000, 4096,
                                      w - 257, w - 129, w - 128)),
        "below 0": (data, starts(-1, -5, -127, -128, -129, -100_000,
                                 -2 ** 31)),
        "at or past the width": (data, starts(w - 1, w, w + 3, w + 200,
                                              2 ** 31 - 1)),
        "n = 1": (data, starts(1000)),
    }


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts 4 B past a 16 B boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def extract_cases(inp: dict, dev) -> dict:
    """{case: (data, starts)} for the window row sums: the tool's windows,
    the alpha-sum probe's cases (`blend_cases`: the kernel scale's 8,192
    windows, edge windows, below 0, at or past the width, one window),
    rows that are not 16 B aligned (width 8,323) and data 4 B past a 16 B
    boundary (both take the aligned modes' 4 B loads)."""
    data = torch.as_tensor(inp["data"], device=dev)
    cases = {"the tool's windows": (data,
                                    torch.as_tensor(inp["starts"],
                                                    device=dev))}
    cases.update({k: v for k, v in blend_cases(inp, dev).items()
                  if k != "the tool's inputs, |row 2|"})
    odd = torch.as_tensor(np.random.default_rng(6).normal(
        size=(probes.REC, 8323)).astype(np.float32), device=dev)
    st = torch.tensor([-200, -3, 0, 5, 127, 128, 4100, 8194, 8195, 8196,
                       8300, 8323], dtype=torch.int32, device=dev)
    cases["width 8,323"] = (odd, st)
    cases["data 4 B past 16 B"] = (misaligned(cases["edge windows"][0]),
                                   cases["edge windows"][1])
    return cases


def cumsum_cases(inp: dict, dev) -> dict:
    """{case: x} for the cumsum: the tool's xs; xs with inf, -inf and NaN
    in rows 0, 5, 50, 100 and 127 (a row's three in columns of their own)
    and one column with +inf in row 5 and -inf in row 100 (NaN from row
    100 on); seeded [16, 16], [48, 80] and [1024, 48]; xs 4 B past a 16 B
    boundary (4 B loads)."""
    xs = torch.as_tensor(inp["xs"], device=dev)
    bad = xs.clone()
    for i, row in enumerate((0, 5, 50, 100, 127)):
        bad[row, 3 * i:3 * i + 3] = torch.tensor(
            [float("inf"), float("-inf"), float("nan")])
    bad[5, 100], bad[100, 100] = float("inf"), float("-inf")
    rng = np.random.default_rng(7)
    cases = {"the tool's xs": xs, "inf, -inf and NaN rows": bad}
    for shape in ((16, 16), (48, 80), (1024, 48)):
        cases[f"{shape}"] = torch.as_tensor(
            rng.normal(size=shape).astype(np.float32), device=dev)
    cases["xs 4 B past 16 B"] = misaligned(bad)
    return cases


def cumsum_differs(got: torch.Tensor, x: torch.Tensor, mode: str):
    """None if the cumsum `got` of x in `mode` holds: fp32 bit for bit
    with the plain version, NaN where it is NaN; tf32 NaN, +inf and -inf
    at the plain version's positions and elsewhere within CUMSUM_TF32_TOL
    of the max of the float64 cumsum.  Else what differs."""
    plain = probes.cumsum_rows_plain(x)
    if mode == "fp32":
        return None if same_floats_or_nan(got, plain) else "bits"
    for flag in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(flag(got), flag(plain)):
            return f"{flag.__name__} positions"
    fin = torch.isfinite(plain)
    ref = probes.cumsum_rows_plain(x.double())[fin]
    err = float((got[fin].double() - ref).abs().max()) if fin.any() else 0.0
    scale = float(ref.abs().max()) if fin.any() else 1.0
    return None if err <= CUMSUM_TF32_TOL * scale else \
        f"{err / scale:.3e} of the max"


def same_floats_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same positions, every other value bit for bit."""
    nan = torch.isnan(b)
    return (a.shape == b.shape and torch.equal(torch.isnan(a), nan)
            and same_floats(a[~nan], b[~nan]))


def timed_in_turns(fns: dict) -> dict:
    """{name: [ms of each turn]}: every fn timed over PROBE_ITERS launches,
    one after another, in PROBE_TURNS turns."""
    times = {k: [] for k in fns}
    for _ in range(PROBE_TURNS):
        for k, fn in fns.items():
            times[k].append(cuda_time_ms(fn, PROBE_ITERS))
    return times


def medians(times: dict) -> dict:
    return {k: float(np.median(v)) for k, v in times.items()}


def spread(times: dict) -> str:
    """'name median (min-max), ...' of `timed_in_turns`' result."""
    return ", ".join(f"{k} {np.median(v):.7f} ({min(v):.7f}-{max(v):.7f})"
                     for k, v in times.items())


def probe_checks(micro, dev):
    """Phase 14, the probes of tools/micro_mosaic_torch.py: each kernel in
    each mode against its plain version on the card (launches not
    counted), the plain versions (and torch.cumsum) timed, the
    accumulation, add_ and the launch floor timed in turns, the bounds.
    `micro` is the tool's run (its kernel times).  Returns {kernel: the
    numbers of its `kernels` entry}."""
    import micro_mosaic_torch as mm

    def ms_of(key):
        return micro[key]["ms"]

    inp = mm.inputs()
    res = {}

    # 5a: window row sums in every mode, bit for bit on every case, then
    # timed at kernel scale
    errs = {m: 0.0 for m in probes.EXTRACT_MODES}
    cases = extract_cases(inp, dev)
    for case, (data, st) in cases.items():
        want = probes.extract_rows_plain(data, st)
        for mode in probes.EXTRACT_MODES:
            got = probes.extract_rows(data, st, mode)
            errs[mode] = max(errs[mode], float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"extract[{mode}] differs from its "
                                     f"plain version on {case}")
    data = torch.as_tensor(inp["data"], device=dev)
    starts = torch.as_tensor(inp["starts"], device=dev)

    def extract_bound(st):
        n = len(st)
        return bound(4 * probes.REC * window_columns(st) + 4 * n
                     + 4 * n * probes.OUT_ROWS * probes.REC,
                     probes.REC * n * (probes.WIN - 1))
    bnd = extract_bound(inp["starts"])
    big, st2 = cases["the tool's inputs"]
    times = timed_in_turns(
        {m: functools.partial(probes.extract_rows, big, st2, m)
         for m in probes.EXTRACT_MODES})
    scale = {"windows": int(st2.shape[0]),
             "bound_ms": extract_bound(inp["st2"])[0],
             "ms": medians(times), "turns_ms": times}
    res[probes.EXTRACT] = {
        "err": max(errs.values()), "ms": ms_of("extract[direct]"),
        "plain_ms": cuda_time_ms(
            lambda: probes.extract_rows_plain(data, starts), 5),
        "bound": bnd, "kernel_scale": scale,
        "modes": {m: {"max_abs_err": errs[m], "ms": ms_of(f"extract[{m}]")}
                  for m in probes.EXTRACT_MODES}}
    print(f"{probes.EXTRACT}: every mode equals the plain version bit for "
          f"bit on {', '.join(cases)}; bound {bnd[0]:.6f} ms ({bnd[1]}); "
          f"at {scale['windows']} windows, ms median (min-max) of "
          f"{PROBE_TURNS} turns: {spread(times)} against a bound of "
          f"{scale['bound_ms']:.6f} ms (bytes)")

    # 5b: cumsum, fp32 bit for bit with the plain version, TF32 at its
    # non-finite positions and to a float64 cumsum elsewhere, on every
    # case; then timed at kernel scale
    cases = cumsum_cases(inp, dev)
    for case, x in cases.items():
        for mode in probes.CUMSUM_MODES:
            bad = cumsum_differs(probes.cumsum_rows(x, mode), x, mode)
            if bad:
                raise AssertionError(f"{probes.CUMSUM}[{mode}] differs from "
                                     f"its plain version on {case}: {bad}")
    xs = cases["the tool's xs"]
    plain = probes.cumsum_rows_plain(xs)
    ref64 = torch.cumsum(xs.double(), dim=0)
    top = float(ref64.abs().max())

    def cumsum_bound(x, peak):
        rows, cols = x.shape
        macs = rows * (rows + 1) // 2 * cols  # L's nonzero part
        return bound(2 * 4 * rows * cols, 2 * macs, peak)
    xl = torch.as_tensor(np.random.default_rng(5).normal(
        size=(128, CUMSUM_SCALE_COLS)).astype(np.float32), device=dev)
    modes = {}
    for mode, peak in (("tf32", PEAK_TF32_PER_S), ("fp32", PEAK_FP32_PER_S)):
        got = probes.cumsum_rows(xs, mode)
        bad = cumsum_differs(probes.cumsum_rows(xl, mode), xl, mode)
        if bad:
            raise AssertionError(f"{probes.CUMSUM}[{mode}] differs from its "
                                 f"plain version at kernel scale: {bad}")
        d64 = float((got.double() - ref64).abs().max()) / top
        modes[mode] = {"max_abs_err": float((got - plain).abs().max()),
                       "rel_err_float64": d64,
                       "ms": ms_of(f"cumsum[{mode}]"),
                       "bound": cumsum_bound(xs, peak)}
        print(f"{probes.CUMSUM}[{mode}]: vs plain max |d| "
              f"{modes[mode]['max_abs_err']:.3e}, vs float64 {d64:.3e} of "
              f"the max; bound {modes[mode]['bound'][0]:.7f} ms "
              f"({modes[mode]['bound'][1]})")
    fns = {m: functools.partial(probes.cumsum_rows, xl, m)
           for m in probes.CUMSUM_MODES}
    fns["torch.cumsum"] = functools.partial(torch.cumsum, xl, dim=0)
    times = timed_in_turns(fns)
    med = medians(times)
    scale = {"shape": [128, CUMSUM_SCALE_COLS],
             "bound_ms": cumsum_bound(xl, PEAK_TF32_PER_S)[0],
             "ms": {m: med[m] for m in probes.CUMSUM_MODES},
             "library_ms": med["torch.cumsum"], "turns_ms": times}
    res[probes.CUMSUM] = {
        "err": max(m["max_abs_err"] for m in modes.values()),
        "ms": modes["tf32"]["ms"], "bound": modes["tf32"]["bound"],
        "plain_ms": cuda_time_ms(lambda: probes.cumsum_rows_plain(xs), 5),
        "library_ms": cuda_time_ms(lambda: torch.cumsum(xs, dim=0),
                                   PROBE_ITERS),
        "kernel_scale": scale,
        "modes": {m: {k: v for k, v in d.items()
                      if k in ("max_abs_err", "rel_err_float64", "ms")}
                  for m, d in modes.items()}}
    print(f"{probes.CUMSUM}: both modes hold on {', '.join(cases)} (fp32 "
          "bit for bit, NaN where the plain version is NaN; TF32 NaN and inf"
          f" at its positions); at [128, {CUMSUM_SCALE_COLS}], ms median "
          f"(min-max) of {PROBE_TURNS} turns: {spread(times)} against a "
          f"bound of {scale['bound_ms']:.6f} ms (bytes)")

    # 5c: accumulation in place, bit for bit on every case, then timed
    ones = torch.ones((8, 128), device=dev)
    got = probes.accumulate_(torch.zeros_like(ones), ones)
    want = probes.accumulate_plain_(torch.zeros_like(ones), ones)
    if not (same_floats(got, want) and bool((got == 2.0).all())):
        raise AssertionError("the accumulation probe is not 2.0 everywhere")
    for i, n in enumerate(ACCUM_SIZES):
        for j, offsets in enumerate(ACCUM_OFFSETS):
            for steps in ACCUM_STEP_COUNTS:
                bad = accum_differs(*accum_case(n, offsets, 100 * i + j, dev),
                                    steps)
                if bad:
                    raise AssertionError(
                        f"{probes.ACCUM} at n {n}, offsets {offsets}, "
                        f"{steps} steps: {bad}")
    for a, b in accum_overlaps(dev):
        try:
            probes.accumulate_(a, b)
        except ValueError:
            continue
        raise AssertionError(f"{probes.ACCUM} took views that overlap")
    buf = torch.zeros_like(ones)
    # in turns: the kernel, one PyTorch call (on the zeroed buffer,
    # out + 2 in is (out + in) + in) and an empty launch, the floor
    times = timed_in_turns({
        "kernel": lambda: probes.accumulate_(buf, ones),
        "add_": lambda: buf.add_(ones, alpha=probes.ACC_STEPS // 2),
        "floor": lambda: torch.cuda._sleep(0)})
    med = medians(times)
    res[probes.ACCUM] = {
        "err": float((got - want).abs().max()), "ms": med["kernel"],
        "plain_ms": cuda_time_ms(
            lambda: probes.accumulate_plain_(buf, ones), PROBE_ITERS),
        "library_ms": med["add_"], "launch_floor_ms": med["floor"],
        "turns_ms": times,
        "bound": bound(3 * 4 * ones.numel(), probes.ACC_STEPS // 2
                       * ones.numel())}
    print(f"{probes.ACCUM}: bit for bit with the plain version on "
          f"{len(ACCUM_SIZES) * len(ACCUM_OFFSETS) * len(ACCUM_STEP_COUNTS)}"
          " seeded views, in place, refusing overlapping views; at [8, 128],"
          f" ms median (min-max) of {PROBE_TURNS} turns: {spread(times)}")
    floor = med["floor"]
    for name in (probes.EXTRACT, probes.CUMSUM, probes.ACCUM):
        res[name]["launch_floor_ms"] = floor
    print(f"launch floor (an empty launch, torch.cuda._sleep(0)) "
          f"{floor:.7f} ms beside the bounds of "
          + ", ".join(f"{name} {res[name]['bound'][0]:.7f} ms"
                      for name in (probes.EXTRACT, probes.CUMSUM,
                                   probes.ACCUM)))

    # 5d: alpha sums on the tool's inputs (its row 2 is N(0, 1): where it
    # is negative exp overflows and the sums are +-inf or NaN), with row 2
    # made positive, and on edge windows, bit for bit
    modes = {f"extract={e}": {"max_abs_err": 0.0,
                              "ms": ms_of(f"blend[extract={e}]")}
             for e in probes.BLEND_MODES}
    cases = blend_cases(inp, dev)
    for case, (data, starts) in cases.items():
        for extract in probes.BLEND_MODES:
            got = probes.alpha_sums(data, starts, extract)
            want = probes.alpha_sums_plain(data, starts, extract)
            if not same_floats_or_nan(got, want):
                raise AssertionError(f"{probes.BLEND}[extract={extract}] "
                                     f"differs from its plain version on "
                                     f"{case}")
            mode = modes[f"extract={extract}"]
            mode["max_abs_err"] = max(mode["max_abs_err"], float(torch.where(
                torch.isfinite(want), got - want, 0.0).abs().max()))
            if case == "the tool's inputs":
                print(f"{probes.BLEND}[extract={extract}] on the tool's "
                      f"inputs: {int(torch.isnan(got).sum())} NaN and "
                      f"{int(torch.isinf(got).sum())} inf of {got.numel()}"
                      " sums, at the plain version's positions")
    print(f"{probes.BLEND}: every mode equals the plain version bit for "
          f"bit (NaN where it is NaN) on {', '.join(cases)}")
    big = torch.as_tensor(inp["big"], device=dev)
    st2 = torch.as_tensor(inp["st2"], device=dev)
    n = st2.shape[0]
    pairs = n * probes.PIX * probes.WIN
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    sfu_per_s = SM_COUNT * SFU_PER_CLOCK_SM * clock_mhz * 1e6
    work = (4 * 3 * window_columns(inp["st2"]) + 4 * n + 4 * n * probes.PIX,
            7 * pairs, PEAK_FP32_PER_S, pairs, sfu_per_s)
    terms = bound_terms(*work)
    bnd = bound(*work)
    res[probes.BLEND] = {
        "err": max(m["max_abs_err"] for m in modes.values()),
        "ms": modes["extract=True"]["ms"],
        "plain_ms": cuda_time_ms(
            lambda: probes.alpha_sums_plain(big, st2, True), 2),
        "bound": bnd, "bound_terms_ms": terms, "modes": modes}
    ms = res[probes.BLEND]["ms"]
    top = max(terms, key=terms.get)
    print(f"{probes.BLEND}: {ms:.5f} ms; bound {bnd[0]:.6f} ms by "
          f"{'the exps on the SFU' if top == 'sfu' else top} "
          f"(terms in ms: {pairs} exps on the "
          f"SFU at {SM_COUNT} x {SFU_PER_CLOCK_SM} a clock x {clock_mhz:g} "
          f"MHz {terms['sfu']:.6f}, 7 fp32 operations a pair "
          f"{terms['operations']:.6f}, bytes {terms['bytes']:.6f}), "
          f"{bnd[0] / ms:.3f} of it")
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


def tools_on_path():
    """Puts the repository's tools/ on sys.path, where phase 14's tools
    are imported from."""
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)


def probe_phase(dev):
    """Phase 14: both tools driven through `run` with the launch counts
    from 0, then the checks.  Returns ({kernel: launches}, {kernel: the
    numbers of its `kernels` entry})."""
    tools_on_path()
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
    # the ablation tool projects its scene once and bins it once, through
    # the projection's and the binning's kernels
    want.update({k: 1 for k in binning.KERNELS})
    want[projection_ops.FWD_KERNEL] = 1
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
        if blend_launches(launches) != {name: frames}:
            raise AssertionError(f"render_sets launched {launches} for "
                                 f"{frames} frames")
        check_sampler(launches, "render_sets", bwd=0)
        check_binning(launches, "render_sets")
        check_ssim(launches, "render_sets", 0, 0)
        check_projection(launches, "render_sets", 2 * frames, 0)

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
    torch.profiler, left in `profiler`.  `loop_ssims` counts the SSIMs the
    trainer scores outside its steps (pair gates, eval frames)."""

    TIMED = ("_cvpm_and_densify", "_graph_downsample", "evaluate",
             "save_model", "save_training_state")

    def __init__(self, staged_step: int, profiled=()):
        self.staged_step, self.stages = staged_step, StageTimer()
        self.events, self.losses = [], []
        self.seconds = {name: [] for name in self.TIMED}
        self.kmax, self.grows = [], []
        self.raster, self.capturing = {}, False
        self.profiled, self.profiler = tuple(profiled), None
        self.loop_ssims = 0

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
        ssim0 = train_loop.ssim

        def counted_ssim(*a, **kw):
            self.loop_ssims += 1
            return ssim0(*a, **kw)

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
        train_loop.ssim = counted_ssim
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(cls, name, fn)
            rasterize_ops.raster_fwd = raster_fwd0
            rasterize_ops.raster_bwd = raster_bwd0
            train_loop.ssim = ssim0
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
        if blend_launches(launches) != want:
            raise AssertionError(f"training launched {launches}, not {want}")
        check_sampler(launches, "training from disk")
        check_binning(launches, "training from disk")
        # an SSIM a view a step, and the ones the loop scored: a
        # consistency pair's gate (cached by camera pair) or an eval frame
        check_ssim(launches, "training from disk",
                   MV * steps + probe.loop_ssims, MV * steps)
        # a view or an eval frame: a prefilter and a render
        check_projection(launches, "training from disk",
                         2 * want[kernels[0]], MV * steps)
        staged_view_checks(probe, tile)
        probe.raster.clear()

        # resume a copy of the iteration-45 checkpoint in a subprocess
        model2 = os.path.join(tmp, "model_resumed")
        start = copy_checkpoint(model1, model2)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent
                                 / "train_torch.py"), *argv, "-m", model2,
             "--checkpoint_iterations", str(TRAIN_ITERS),
             "--start_checkpoint", start],
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
    if blend_launches(launches) != {name: DISK_VIEWS}:
        raise AssertionError(f"render_torch.py launched {launches} for "
                             f"{DISK_VIEWS} views")
    check_sampler(launches, "render_torch.py", bwd=0)
    check_binning(launches, "render_torch.py")
    check_ssim(launches, "render_torch.py", 0, 0)
    check_projection(launches, "render_torch.py", 2 * DISK_VIEWS, 0)

    # 2. the metrics CLI with seeded LPIPS weights at VGG16's widths, each
    # test view recomputed on the CPU from the same PNG pixels
    npz = os.path.join(model_dir, "lpips_random.npz")
    np.savez(npz, **lpips.random_weights(args.seed))
    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    metrics_torch.main(["-m", model_dir, "--lpips_weights", npz])
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - t0
    metric_launches = dict(cuda_lib.LAUNCHES)
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
    check_ssim(metric_launches, "metrics_torch.py", bwd=0)
    check_projection(metric_launches, "metrics_torch.py", 0, 0)
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
    if blend_launches(orbit_launches) != {name: ORBIT_FRAMES}:
        raise AssertionError(f"the orbit launched {orbit_launches} for "
                             f"{ORBIT_FRAMES} frames")
    check_sampler(orbit_launches, "the orbit",
                  ORBIT_FRAMES * planes_sampled(level), 0)
    check_binning(orbit_launches, "the orbit")
    check_ssim(orbit_launches, "the orbit", 0, 0)
    check_projection(orbit_launches, "the orbit", 2 * ORBIT_FRAMES, 0)

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
    total = collections.Counter(launches)
    total.update(metric_launches)
    total.update(orbit_launches)
    return dict(total)


# ---------------------------------------------------------------------
# phase 18: the sharded step (splatco_torch/parallel)


def digest(tree) -> str:
    """sha256 of every leaf of a nested dict/list tree, with its path."""
    h = hashlib.sha256()
    for key, leaf in sorted(flat(tree).items()):
        h.update(key.encode())
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def state_tree(carry):
    """A rank's whole step state (params, moments, statistics) as a tree."""
    params, opt_state, stats = carry
    return {"p": params, "mu": opt_state["mu"], "nu": opt_state["nu"],
            "s": {f: getattr(stats, f) for f in STAT_FIELDS}}


def lr_of_leaves(opt, extent: float, params, opt_state, level: int = 0):
    """{leaf path: its group's learning rate at the state's count}."""
    labels = flat(label_params(params))
    scheds = group_schedules(opt, extent, level)
    return {key: float(scheds[lbl](opt_state["sched_count"][lbl]))
            for key, lbl in labels.items()}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argv, n: int, env, timeout: float):
    """`python argv` as n ranks under torchrun (torch.distributed.run
    --standalone), in a session of their own: (exit code, output).  When
    one rank fails torchrun stops the others; when the time runs out the
    session is killed, the ranks with it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", *argv], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    return proc.returncode, out


def launches_of(fn, *args, **kwargs):
    """(fn's result, the kernel launches it made)."""
    before = collections.Counter(cuda_lib.LAUNCHES)
    out = fn(*args, **kwargs)
    return out, dict(cuda_lib.LAUNCHES - before)


def grad_err(got, want) -> float:
    """The largest per-leaf error of gradient tree `got` against `want`,
    each leaf's relative to its max (absolute where the max is 0)."""
    worst, got = 0.0, flat(got)
    for key, w in flat(want).items():
        scale = float(w.abs().max())
        err = float((got[key] - w).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def one_rank_phase(params, state, cfg, args, dev):
    """Phase 18a: a 1x1 mesh over NCCL (world size 1) in this process, at
    full width: one sharded step against make_train_step(mv=1, q = 0)
    from the same state, both through the tile kernels on view 0.  Returns
    the sharded steps' launches and {name: ms/step}."""
    if not distributed.init_distributed(f"localhost:{free_port()}", 1, 0,
                                        backend="nccl"):
        raise RuntimeError("the 1x1 process group was not made")
    try:
        mesh = distributed.make_multihost_mesh(1, 1)
        cams = orbit_cameras(MV, dev)
        cam, gt = cams[0], smooth_targets(1, args.seed, dev)[0]
        opt = OptimizationConfig()
        extent = camera_extent(cams)
        tx = make_optimizer(opt, params, extent, 0, device=dev)
        start = (params, tx.init(params),
                 init_stats(params["anchors"]["anchor"].shape[0],
                            cfg.n_offsets, device=dev))
        sharded = make_sharded_train_step(cfg, opt, mesh, tx,
                                          backend="cuda", q_noise=0.0)
        single = make_train_step(cfg, opt, 1, 0, tx, q_noise=0.0,
                                 device=dev)
        bg = torch.zeros(3, device=dev)

        def run_sharded():
            return sharded(*start[:2], state.active, state.contractor,
                           start[2], cam, gt, 0, *TERMS.values())

        def run_single():
            return single(*start[:2], state.active, state.contractor,
                          start[2], [cam], [gt], bg, None, 0,
                          *TERMS.values())

        cuda_lib.LAUNCHES.clear()
        got = run_sharded()
        ms = {"sharded": cuda_time_ms(run_sharded, SHARDED_ONE_ITERS)}
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        want = run_single()
        ms["single"] = cuda_time_ms(run_single, SHARDED_ONE_ITERS)
    finally:
        torch.distributed.destroy_process_group()

    rel = abs(float(got[3]["loss"]) - float(want[3]["loss"])) / abs(
        float(want[3]["loss"]))
    lrs = lr_of_leaves(opt, extent, params, start[1])
    p_got, p_want = flat(got[0]), flat(want[0])
    mu_got, mu_want = flat(got[1]["mu"]), flat(want[1]["mu"])
    worst_mu, over_lr, differ, total = 0.0, [], 0, 0
    for key, w in p_want.items():
        d = (p_got[key] - w).abs()
        differ += int((d > 0).sum())
        total += w.numel()
        if float(d.max()) > 2.0 * lrs[key] * (1 + 1e-6):
            over_lr.append(key)
        scale = float(mu_want[key].abs().max())
        if scale > 0:
            worst_mu = max(worst_mu, float((mu_got[key] - mu_want[key]).abs()
                                           .max()) / scale)
    print(f"18a. 1x1 mesh over NCCL, {WIDTH}x{HEIGHT}, one view: loss "
          f"{float(got[3]['loss']):.8f} sharded vs "
          f"{float(want[3]['loss']):.8f} single, rel {rel:.3e} (limit "
          f"{SHARDED_ONE_LOSS_TOL}); first moments max-normalised "
          f"{worst_mu:.3e} (limit {SHARDED_ONE_MU_TOL}); {differ} of "
          f"{total} param elements differ, {len(over_lr)} leaves beyond "
          f"2 lr {over_lr[:4]}; "
          f"{ms['sharded']:.3f} ms/step sharded, {ms['single']:.3f} ms/step "
          f"single (CUDA events, {SHARDED_ONE_ITERS} steps from one state); "
          f"launches {launches}")
    if not (rel <= SHARDED_ONE_LOSS_TOL and worst_mu <= SHARDED_ONE_MU_TOL
            and not over_lr):
        raise AssertionError("the 1x1 sharded step disagrees with the "
                             "single-device step")
    check_binning(launches, "18a's sharded steps")
    check_ssim(launches, "18a's sharded steps")
    check_projection(launches, "18a's sharded steps")
    return launches, ms


def small_model(seed: int, dev):
    """tests/test_parallel.py's model size: 200 points, feat_dim 16,
    n_offsets 4, plane_size 64."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0], white_background=False)
    pts = np.random.default_rng(seed).normal(size=(200, 3)).astype(
        np.float32) * 0.4
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    h, w = SMALL_SHARDED
    cams = [look_at_camera([math.sin(i), 0.3, -3.0 + 0.1 * i], [0, 0, 0],
                           [0, -1, 0], 1.0, 1.0 * h / w, w, h, uid=i,
                           device=dev) for i in range(SHARDED_MESH[0])]
    gts = torch.as_tensor(np.random.default_rng(seed + 1).uniform(
        size=(SHARDED_MESH[0], 3, h, w)).astype(np.float32)).to(dev)
    return cfg, params, state, cams, gts


def gloo_cuda_ops(dev) -> dict:
    """Which collectives gloo takes on CUDA tensors, tried once each on a
    4-element tensor over the world group: {op: "ok" or the error}."""
    world = torch.distributed.get_world_size()
    x = torch.ones(4 * world, device=dev)
    ops = {
        "all_reduce": lambda: torch.distributed.all_reduce(x.clone()),
        "all_gather": lambda: torch.distributed.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "broadcast": lambda: torch.distributed.broadcast(x.clone(), 0),
        "reduce_scatter": lambda: torch.distributed.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(world)]),
        "all_to_all": lambda: torch.distributed.all_to_all(
            [torch.empty_like(x) for _ in range(world)],
            [x.clone() for _ in range(world)]),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as err:
            out[name] = str(err).splitlines()[0][:80]
    return out


def sharded_rank(out_dir: str) -> int:
    """One rank of phases 18b-c (run by sharded_phase under torchrun,
    with SPLATCO_BACKEND=gloo)."""
    if not distributed.init_distributed():
        raise RuntimeError("a sharded rank needs torchrun's variables")
    dev = torch.device("cuda")
    rank = torch.distributed.get_rank()
    mesh = distributed.make_multihost_mesh(*SHARDED_MESH)
    res = {"rank": rank, "gloo_cuda": gloo_cuda_ops(dev)}
    seed = int(os.environ["CHIP_SMOKE_SEED"])

    # 18b. the quick-start model at full width: view row = orbit view,
    # gauss column = a 544 px strip
    cfg = quickstart_config()
    pts = np.random.default_rng(seed).normal(size=(65536, 3)).astype(
        np.float32) * 1.2
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    params = untie_offsets(params, seed)
    cams = orbit_cameras(MV, dev)[:SHARDED_MESH[0]]
    gts = smooth_targets(SHARDED_MESH[0], seed, dev)
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, camera_extent(cams), 0, device=dev)
    p, o, a, st = shard_params(
        mesh, params, tx.init(params), state.active,
        init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                   device=dev))
    del params
    step = make_sharded_train_step(cfg, opt, mesh, tx, backend="cuda",
                                   q_noise=0.0, device=dev)
    cam, gt = cams[mesh.view], gts[mesh.view]

    def run(carry):
        return step(carry[0], carry[1], a, state.contractor, carry[2], cam,
                    gt, 0, *TERMS.values())

    def digests(carry):
        """Every rank's digest of its replicated params (all but the
        anchor groups), in rank order."""
        out = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(out, digest(
            {k: v for k, v in carry[0].items() if k != "anchors"}))
        return out

    cuda_lib.LAUNCHES.clear()
    out = run((p, o, st))
    res["loss0"] = float(out[3]["loss"])
    res["clipped_strips"] = out[3]["num_clipped_strips"].tolist()
    res["digests"] = [digests(out[:3])]
    carry, ms, wall = out[:3], [], []
    for _ in range(SHARDED_TIMED):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run(carry)
        stop.record()
        stop.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        ms.append(start.elapsed_time(stop))
        carry = out[:3]
        res["digests"].append(digests(carry))
    res["ms"], res["wall_ms"] = ms, wall
    res["losses"] = [res["loss0"], float(out[3]["loss"])]
    with collectives.trace() as traced:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(carry)
        torch.cuda.synchronize()
        res["traced_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    res["collectives"] = {f"{op}/{group}": rec
                          for (op, group), rec in traced.items()}
    res["repeat"] = [digest(state_tree(run(carry)[:3])) for _ in range(2)]
    torch.cuda.synchronize()
    res["launches_b"] = dict(cuda_lib.LAUNCHES)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # 18b in 16 px tiles (SPLATCO_RASTER=v3's configuration, read at call
    # time): one step from the same state on the same strips
    tile16_default = rasterize_ops.TILE16_DEFAULT
    rasterize_ops.TILE16_DEFAULT = True
    step16 = make_sharded_train_step(
        dataclasses.replace(cfg, kmax=KMAX_V3), opt, mesh, tx,
        backend="cuda", q_noise=0.0, device=dev)
    out, res["launches_b16"] = launches_of(
        step16, p, o, a, state.contractor, st, cam, gt, 0, *TERMS.values())
    res["loss16"] = float(out[3]["loss"])
    res["clipped_strips16"] = out[3]["num_clipped_strips"].tolist()
    res["digests16"] = digests(out[:3])
    rasterize_ops.TILE16_DEFAULT = tile16_default
    del p, o, st, carry, out, a, state
    torch.cuda.empty_cache()

    # 18c. small size: the kernel path against dense under the sharded
    # step, then the sharded loop against the single-device trajectory
    cfg, params, state, cams, gts = small_model(seed, dev)
    res["small_capacity"] = params["anchors"]["anchor"].shape[0]
    launches_c = collections.Counter()
    grads = {}
    for backend in ("cuda", "dense"):
        (g, stats, metrics), n = launches_of(
            step_gradients, mesh, cfg, params, state.active,
            state.contractor, cams[mesh.view], gts[mesh.view], backend, dev)
        launches_c.update(n)
        grads[backend] = (g, stats, float(metrics["loss"]))
    res["small_grad_err"] = grad_err(grads["cuda"][0], grads["dense"][0])
    res["small_loss"] = [grads["cuda"][2], grads["dense"][2]]
    res["small_demon"] = [float(grads[b][1].anchor_demon.sum())
                          for b in ("cuda", "dense")]
    # in 16 px tiles: the sharded step's gradients against the
    # single-device step's (mv = 2), offsets untied and as initialised
    rasterize_ops.TILE16_DEFAULT = True
    cfg16 = dataclasses.replace(cfg, kmax=KMAX_V3)
    for name, prm in (("untied", untie_offsets(params, seed)),
                      ("tied", params)):
        (g, _, m), n = launches_of(
            step_gradients, mesh, cfg16, prm, state.active,
            state.contractor, cams[mesh.view], gts[mesh.view], "cuda", dev)
        launches_c.update(n)
        g_sd, _, m_sd = single_gradients(cfg16, prm, state.active,
                                         state.contractor, cams, gts,
                                         "cuda", dev)
        res[f"small16_{name}"] = {
            "grad_err": grad_err(g, g_sd),
            "loss": [float(m["loss"]), float(m_sd["loss"])],
            "clipped": [int(m["num_clipped"]), int(m_sd["num_clipped"])]}
    rasterize_ops.TILE16_DEFAULT = tile16_default
    res["loop"] = sharded_loop(mesh, cfg, params, state.active,
                               state.contractor, cams, gts, "cuda", dev)
    launches_c.update(res["loop"]["launches_sharded"])
    res["launches_c"] = dict(launches_c)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    torch.distributed.destroy_process_group()
    return 0


def sharded_phase(params, state, cfg, args, dev, card: str):
    """Phase 18: the sharded step on the card.  18a in this process over
    NCCL; 18b-c in four ranks that share the card over gloo (so their
    times are of four processes on one card, not of four cards).
    Returns the launches of phase 18's sharded steps."""
    t_phase = time.perf_counter()
    launches_a, _ = one_rank_phase(params, state, cfg, args, dev)

    # the single-device steps the 2x2 mesh's first steps are held to:
    # mv = 2 (orbit views 0 and 1), q = 0, from the same initial state
    # (the offsets untied, as in the ranks), in 32 px and in 16 px tiles
    cams = orbit_cameras(MV, dev)[:SHARDED_MESH[0]]
    gts = smooth_targets(SHARDED_MESH[0], args.seed, dev)
    opt = OptimizationConfig()
    untied = untie_offsets(params, args.seed)
    tx = make_optimizer(opt, untied, camera_extent(cams), 0, device=dev)
    want = {}
    for tile16, c in ((False, cfg), (True, dataclasses.replace(
            cfg, kmax=KMAX_V3))):
        single = make_train_step(c, opt, SHARDED_MESH[0], 0, tx,
                                 q_noise=0.0, device=dev, tile16=tile16)
        m = single(untied, tx.init(untied), state.active, state.contractor,
                   init_stats(params["anchors"]["anchor"].shape[0],
                              cfg.n_offsets, device=dev),
                   cams, gts, torch.zeros(3, device=dev), None, 0,
                   *TERMS.values())[3]
        want[tile16] = (float(m["loss"]), int(m["num_clipped"]))
    del m, single, tx, untied
    torch.cuda.empty_cache()

    n = SHARDED_MESH[0] * SHARDED_MESH[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPLATCO_COORDINATOR", "SPLATCO_NUM_PROCESSES",
                        "SPLATCO_PROCESS_ID")}
    env.update(SPLATCO_BACKEND="gloo", CHIP_SMOKE_SEED=str(args.seed))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        code, text = run_ranks(
            [os.path.abspath(__file__), "--sharded-rank", tmp], n, env,
            SHARDED_RANK_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"the sharded ranks exited {code}:\n"
                                 f"{text[-6000:]}")
        ranks = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.json")) as fh:
                ranks.append(json.load(fh))

    r0 = ranks[0]
    print(f"18b. gloo on CUDA tensors ({torch.__version__}): "
          f"{json.dumps(r0['gloo_cuda'])}")
    ms = [r["ms"] for r in ranks]
    wall = [r["wall_ms"] for r in ranks]
    (want_loss, want_clipped), (want16, want16_clipped) = (want[False],
                                                           want[True])
    rel = abs(r0["loss0"] - want_loss) / abs(want_loss)
    clipped = r0["clipped_strips"]
    loss_tol = (SHARDED_LOSS_TOL if sum(clipped) + want_clipped == 0
                else SHARDED_LOSS_TOL_CLIPPED)
    rel16 = abs(r0["loss16"] - want16) / abs(want16)
    clipped16 = r0["clipped_strips16"]
    loss16_tol = (SHARDED_LOSS_TOL if sum(clipped16) + want16_clipped == 0
                  else SHARDED_LOSS_TOL_CLIPPED)
    print(f"18b. 2x2 mesh, 4 ranks sharing one card ({card}) over gloo, "
          f"{WIDTH}x{HEIGHT} views in {SHARDED_MESH[1]} strips of "
          f"{HEIGHT // SHARDED_MESH[1]} px: first step loss "
          f"{r0['loss0']:.8f} vs {want_loss:.8f} single-device mv=2, rel "
          f"{rel:.3e} (limit {loss_tol}); "
          f"num_clipped per strip {clipped} (single-device {want_clipped}); "
          f"losses {r0['losses']}")
    print(f"18b. ms/step per rank (CUDA events, {SHARDED_TIMED} steps; 4 "
          f"ranks on one card, not a multi-card figure): {json.dumps(ms)}; "
          f"host clock {json.dumps(wall)}; peak device memory per rank "
          f"{[round(r['peak_gib'], 3) for r in ranks]} GiB")
    for r in ranks[:1]:
        tot = sum(rec[1] for rec in r["collectives"].values())
        print(f"18b. rank 0 traced step: {r['traced_wall_ms']:.1f} ms host "
              f"clock (device synchronised around each collective), of "
              f"which collectives {1e3 * tot:.1f} ms:")
        for name, (calls, secs, payload) in sorted(r["collectives"].items()):
            print(f"  {name}: {calls} calls, {1e3 * secs:.2f} ms, "
                  f"{payload / 1e6:.3f} MB a rank puts in")
    same = all(len(set(d)) == 1 for r in ranks for d in r["digests"])
    same_across = len({d[0] for r in ranks for d in r["digests"][-1:]}) == 1
    repeat = all(r["repeat"][0] == r["repeat"][1] for r in ranks)
    print(f"18b. replicated params bit-identical on the 4 ranks after each "
          f"of {len(r0['digests'])} steps: {same and same_across}; two "
          f"steps from one state bit-identical on every rank: {repeat}")
    steps_b = 1 + SHARDED_TIMED + 1 + 2
    kernels = (KERNEL, BWD_KERNEL)
    launches_b = collections.Counter()
    launches_c = collections.Counter()
    for r in ranks:
        launches_b.update(r["launches_b"])
        launches_c.update(r["launches_c"])
    print(f"18b. launches over the 4 ranks ({steps_b} steps each): "
          f"{dict(launches_b)}")
    launches_b16 = collections.Counter()
    for r in ranks:
        launches_b16.update(r["launches_b16"])
    same16 = len({d for r in ranks for d in r["digests16"]}) == 1
    print(f"18b. 16 px tiles (kmax {KMAX_V3}), one step from the same "
          f"state: loss {r0['loss16']:.8f} vs {want16:.8f} single-device "
          f"mv=2, rel {rel16:.3e} (limit {loss16_tol}); num_clipped per "
          f"strip {clipped16} (single-device {want16_clipped}); replicated "
          f"params bit-identical on the 4 ranks: {same16}; launches "
          f"{dict(launches_b16)}")
    if not (same and same_across and repeat and same16):
        raise AssertionError("the sharded step is not deterministic")
    if rel > loss_tol or rel16 > loss16_tol:
        raise AssertionError("the 2x2 sharded step's loss disagrees with "
                             "the single-device step")
    if blend_launches(launches_b) != {k: n * steps_b for k in kernels}:
        raise AssertionError(f"each rank must launch each of {kernels} "
                             f"once a step")
    if blend_launches(launches_b16) != {KERNEL16: n, BWD_KERNEL16: n}:
        raise AssertionError("each rank must launch each 16 px kernel once "
                             "in its 16 px step")
    check_sampler(launches_b, "18b's sharded steps")
    check_binning(launches_b, "18b's sharded steps")
    check_ssim(launches_b, "18b's sharded steps")
    check_projection(launches_b, "18b's sharded steps")
    check_binning(launches_b16, "18b's 16 px sharded step")
    check_ssim(launches_b16, "18b's 16 px sharded step")
    check_projection(launches_b16, "18b's 16 px sharded step")
    check_sampler(launches_b16, "18b's 16 px sharded step")

    loop = r0["loop"]
    sh, sd = np.asarray(loop["losses_sharded"]), np.asarray(
        loop["losses_single"])
    delta = float(np.max(np.abs(sh - sd) / np.abs(sd)))
    print(f"18c. {SMALL_SHARDED[0]}x{SMALL_SHARDED[1]}, 2x2: kernel path vs "
          f"dense gradients max-normalised "
          f"{max(r['small_grad_err'] for r in ranks):.3e} (limit "
          f"{SHARDED_GRAD_TOL}), loss {r0['small_loss']}; sharded loop "
          f"(cuda) {len(sh)} steps vs single-device: max rel {delta:.3e} "
          f"(limit {LOOP_TOL}), densify {loop['densify']}, capacity "
          f"{loop['capacity']}")
    for name in ("untied", "tied"):
        print(f"18c. 16 px tiles, offsets {name}: sharded vs single-device "
              f"mv=2 gradients max-normalised "
              f"{max(r[f'small16_{name}']['grad_err'] for r in ranks):.3e}"
              + (f" (limit {SHARDED16_GRAD_TOL})" if name == "untied"
                 else " (not checked: tied depths order by slot rank)")
              + f", loss {r0[f'small16_{name}']['loss']}, num_clipped "
              f"{r0[f'small16_{name}']['clipped']}")
    want_c = {KERNEL: n * (1 + len(sh)), BWD_KERNEL: n * (1 + len(sh)),
              KERNEL16: 2 * n, BWD_KERNEL16: 2 * n}
    print(f"18c. launches of the sharded steps over the 4 ranks (rank 0's "
          f"single-device steps not counted): {dict(launches_c)}")
    if max(r["small_grad_err"] for r in ranks) > SHARDED_GRAD_TOL or abs(
            r0["small_loss"][0] - r0["small_loss"][1]) > 1e-5 * abs(
            r0["small_loss"][1]):
        raise AssertionError("the kernel path and dense disagree under the "
                             "sharded step")
    for r in ranks:
        u = r["small16_untied"]
        if (u["grad_err"] > SHARDED16_GRAD_TOL or any(u["clipped"])
                or abs(u["loss"][0] - u["loss"][1]) > 1e-5 * abs(
                    u["loss"][1])):
            raise AssertionError("in 16 px tiles the sharded step disagrees "
                                 "with the single-device step")
    if blend_launches(launches_c) != want_c:
        raise AssertionError(f"18c's sharded steps must launch {want_c}")
    check_sampler(launches_c, "18c's sharded steps")
    check_binning(launches_c, "18c's sharded steps")
    check_ssim(launches_c, "18c's sharded steps")
    check_projection(launches_c, "18c's sharded steps")
    if not (delta < LOOP_TOL and sum(d[1][0] for d in loop["densify"]) > 0
            and loop["capacity"][0] == 2 * r0["small_capacity"]):
        raise AssertionError("the sharded loop left the single-device "
                             "trajectory")
    print(f"  phase 18 wall {time.perf_counter() - t_phase:.1f} s (ranks "
          f"{spawn_s:.1f} s)")
    total = collections.Counter(launches_a)
    total.update(launches_b)
    total.update(launches_b16)
    total.update(launches_c)
    return dict(total)


# ---------------------------------------------------------------------
# phase 19: the last user paths -- the viewer, the profiling switches and
# the hard quality protocol


def sibr_message(cam, train: bool, keep_alive: bool, modifier: float,
                 zero: bool = False) -> dict:
    """The SIBR viewer's message for `cam`, with the viewer's sign flips
    that the server undoes; `zero` asks for no image."""
    view = cam.world_view_transform.cpu().numpy().copy()
    proj = cam.full_proj_transform.cpu().numpy().copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj[:, 1] *= -1
    return {"resolution_x": 0 if zero else cam.image_width,
            "resolution_y": 0 if zero else cam.image_height,
            "train": train, "fov_y": cam.fovy, "fov_x": cam.fovx,
            "z_near": 0.01, "z_far": 100.0, "shs_python": False,
            "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": modifier,
            "view_matrix": view.reshape(-1).tolist(),
            "view_projection_matrix": proj.reshape(-1).tolist()}


def sibr_roundtrip(sock, msg: dict):
    """(image bytes or None, verify string, ms from send to last byte)."""
    def recv(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise AssertionError("the viewer server closed early")
            buf += chunk
        return buf

    raw = json.dumps(msg).encode("utf-8")
    t0 = time.perf_counter()
    sock.sendall(len(raw).to_bytes(4, "little") + raw)
    img = None
    if msg["resolution_x"] and msg["resolution_y"]:
        img = recv(msg["resolution_x"] * msg["resolution_y"] * 3)
    verify = recv(int.from_bytes(recv(4), "little")).decode("ascii")
    return img, verify, 1e3 * (time.perf_counter() - t0)


def wait_until(cond, what: str, timeout: float):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def viewer_client(servers: list, cam, out: dict):
    """19a's SIBR client, on its own thread: frames while the run trains,
    a pause held for 0.5 s, two paused frames (scaling_modifier 1 and 0.5)
    held byte for byte to the port's `render` of the published snapshot,
    a zero-resolution message, then resume with keep_alive and frames
    until the run has finished and after.  Fills `out`; any failure lands
    in out["error"], and the socket closes either way, which lets the run
    end."""
    out.update(served=0, references=0, ms={"training": [], "paused": [],
                                           "after_end": []})
    try:
        wait_until(lambda: servers, "the viewer server", 600)
        srv = servers[0]
        tr = srv.trainer
        with socket.create_connection(("127.0.0.1", srv.port), 60) as sock:
            sock.settimeout(300)

            def frame(train, keep_alive, modifier, phase):
                img, verify, ms = sibr_roundtrip(
                    sock, sibr_message(cam, train, keep_alive, modifier))
                out["served"] += 1
                out["ms"][phase].append(ms)
                out["verify"] = verify
                return img

            t0 = time.monotonic()
            while tr.published.iteration < VIEWER_PAUSE_AT:
                frame(True, False, 1.0, "training")
                if time.monotonic() - t0 > 600:
                    raise AssertionError("the run did not reach iteration "
                                         f"{VIEWER_PAUSE_AT}")
            sibr_roundtrip(sock, sibr_message(cam, False, False, 1.0, True))
            wait_until(lambda: srv.trainer_waiting, "the training gate", 120)
            it0 = tr.published.iteration
            time.sleep(0.5)
            out["paused"] = (it0, tr.published.iteration,
                             srv.trainer_waiting)
            frames, same = {}, {}
            for modifier in (1.0, 0.5):
                frames[modifier] = frame(False, False, modifier, "paused")
                snap = tr.published
                with torch.no_grad():
                    vis = prefilter_voxel(snap.params["anchors"],
                                          snap.active, cam)
                    ref = render(snap.params, snap.active, snap.contractor,
                                 cam, snap.bg, visible_mask=vis,
                                 activate_level=snap.activate_level,
                                 is_training=False, kmax=snap.kmax,
                                 scale_modifier=modifier,
                                 **decode_kwargs(tr.cfg))
                out["references"] += 1
                same[modifier] = eight_bit(ref.image).tobytes() == \
                    frames[modifier]
            out["same_as_render"] = same
            out["modifiers_differ"] = frames[1.0] != frames[0.5]
            img, verify, _ = sibr_roundtrip(
                sock, sibr_message(cam, False, False, 1.0, True))
            out["zero_resolution"] = (img, verify)
            frame(True, True, 1.0, "training")
            while not srv.finished:
                frame(True, True, 1.0, "training")
                if time.monotonic() - t0 > 900:
                    raise AssertionError("the run did not finish")
                time.sleep(0.1)
            out["final_iteration"] = tr.published.iteration
            time.sleep(0.3)
            for _ in range(2):
                frame(True, True, 1.0, "after_end")
    except BaseException:
        import traceback
        out["error"] = traceback.format_exc()


def copy_checkpoint(model_dir: str, run_dir: str) -> str:
    """A copy of `model_dir`'s iteration-TRAIN_CKPT training state (and
    run config) in a new `run_dir`; returns its --start_checkpoint
    argument."""
    os.makedirs(run_dir)
    for name in (f"chkpnt{TRAIN_CKPT}.npz", f"chkpnt{TRAIN_CKPT}.json",
                 "cfg_args.json"):
        shutil.copy(os.path.join(model_dir, name), run_dir)
    return os.path.join(run_dir, f"chkpnt{TRAIN_CKPT}")


def viewer_phase(args, dev, card: str, tmp: str, scene_dir: str,
                 model_dir: str):
    """19a: train_torch.main --gui resumes phase 16's iteration-45 state
    for 20 iterations while viewer_client speaks SIBR messages at full
    width.  Returns the main path's launches (the client's reference
    renders left out)."""
    import train_torch
    from splatco_torch.viewer import network_gui

    t_phase = time.perf_counter()
    tile = raster_v3.TILE if TILE16_DEFAULT else TILE
    kernels = (FWD_KERNELS[tile], BWD_KERNELS[tile])
    run_dir = os.path.join(tmp, "viewer_run")
    start = copy_checkpoint(model_dir, run_dir)
    cam = orbit_camera(3, DISK_VIEWS, width=WIDTH, height_px=HEIGHT,
                       device=dev)
    servers, out = [], {}
    start0 = network_gui.ViewerServer.start

    def start_and_record(srv):
        start0(srv)
        servers.append(srv)

    client = threading.Thread(target=viewer_client,
                              args=(servers, cam, out), daemon=True)
    argv = ["-s", scene_dir, *TRAIN_ARGS, "--seed", str(args.seed),
            "-m", run_dir, "--start_checkpoint", start,
            "--iterations", str(VIEWER_ITERS),
            "--test_iterations", str(VIEWER_ITERS),
            "--save_iterations", str(VIEWER_ITERS),
            "--gui", "--ip", "127.0.0.1", "--port", str(free_port())]
    cuda_lib.LAUNCHES.clear()
    network_gui.ViewerServer.start = start_and_record
    try:
        client.start()
        t0 = time.perf_counter()
        trainer = train_torch.main(argv)
        run_s = time.perf_counter() - t0
    finally:
        network_gui.ViewerServer.start = start0
    client.join(60)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    if client.is_alive():
        raise AssertionError("the viewer client did not finish")
    if "error" in out:
        raise AssertionError(f"the viewer client failed:\n{out['error']}")
    srv = servers[0]
    if srv.error is not None:
        raise AssertionError(f"the viewer server failed:\n{srv.error}")
    if srv._thread.is_alive():
        raise AssertionError("the viewer server did not stop")

    steps = VIEWER_ITERS - TRAIN_CKPT
    eval_frames = (len(trainer.scene.test_cameras())
                   + len(trainer.train_cams[5:30:5]))
    want = {kernels[0]: MV * steps + eval_frames + out["served"]
            + out["references"], kernels[1]: MV * steps}
    ms = {k: [round(v, 1) for v in vals] for k, vals in out["ms"].items()}
    print(f"viewer ({card}): train_torch.main --gui resumed chkpnt"
          f"{TRAIN_CKPT} for {steps} iterations ({run_s:.1f} s), "
          f"{out['served']} frames served at {WIDTH}x{HEIGHT}; ms per "
          f"served frame (host clock, send to last byte): while training "
          f"median {np.median(out['ms']['training']):.1f} of "
          f"{ms['training']}, paused {ms['paused']}, after the last "
          f"iteration {ms['after_end']}; launches {launches} ({eval_frames} "
          f"eval frames, {out['references']} reference renders)")
    print(f"  paused at iteration {out['paused'][0]}, 0.5 s later "
          f"{out['paused'][1]} (trainer at the gate {out['paused'][2]}); "
          f"paused frames equal to render() of the published snapshot "
          f"{out['same_as_render']}, scaling_modifier 1 vs 0.5 differ "
          f"{out['modifiers_differ']}; zero resolution: image "
          f"{out['zero_resolution'][0]!r}, verify "
          f"{out['zero_resolution'][1] == scene_dir}; served after the last "
          f"iteration ({out['final_iteration']}): {len(ms['after_end'])}")
    if not (out["paused"][0] == out["paused"][1] and out["paused"][2]):
        raise AssertionError("train=False did not hold the run")
    if not all(out["same_as_render"].values()):
        raise AssertionError("a paused frame differs from render() of the "
                             "published snapshot")
    if not out["modifiers_differ"]:
        raise AssertionError("scaling_modifier changed nothing")
    if out["zero_resolution"] != (None, scene_dir) or \
            out["verify"] != scene_dir:
        raise AssertionError("the verify string or the zero-resolution "
                             "reply is wrong")
    if out["final_iteration"] != VIEWER_ITERS or len(ms["after_end"]) != 2:
        raise AssertionError("keep_alive did not serve past the last "
                             "iteration")
    if blend_launches(launches) != want:
        raise AssertionError(f"the viewer run launched {launches}, not "
                             f"{want}")
    check_sampler(launches, "the viewer run")
    check_binning(launches, "the viewer run")
    check_ssim(launches, "the viewer run")
    check_projection(launches, "the viewer run")
    print(f"  phase 19a wall {time.perf_counter() - t_phase:.1f} s")
    for name in (kernels[0], *binning.KERNELS):
        launches[name] -= out["references"]
    # a reference render's prefilter and render
    launches[projection_ops.FWD_KERNEL] -= 2 * out["references"]
    return launches


def profile_cli_phase(args, card: str, tmp: str, scene_dir: str,
                      model_dir: str):
    """19b: train_torch.main --profile resumes phase 16's iteration-45
    state for 5 iterations; the Chrome trace must name both blend
    kernels.  Returns the launches."""
    import train_torch

    t_phase = time.perf_counter()
    tile = raster_v3.TILE if TILE16_DEFAULT else TILE
    kernels = (FWD_KERNELS[tile], BWD_KERNELS[tile])
    run_dir = os.path.join(tmp, "profile_run")
    start = copy_checkpoint(model_dir, run_dir)
    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    train_torch.main(["-s", scene_dir, *TRAIN_ARGS, "--seed", str(args.seed),
                      "-m", run_dir, "--start_checkpoint", start,
                      "--iterations", str(PROFILE_ITERS),
                      "--save_iterations", str(PROFILE_ITERS), "--profile"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    path = os.path.join(run_dir, "profile_trace", "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device_us = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            for sym in ("fwd_kernel", "bwd_kernel"):
                if sym in e.get("name", ""):
                    device_us[sym] += e.get("dur", 0)
    sampler_named = any(e.get("name") == "plane_sample" for e in events)
    steps = PROFILE_ITERS - TRAIN_CKPT
    print(f"--profile ({card}): {steps} iterations in {run_s:.1f} s, trace "
          f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, "
          f"{sum(e.get('cat') == 'kernel' for e in events)} kernel events; "
          f"the blend kernels' device ms in the trace "
          f"{ {k: round(v / 1e3, 3) for k, v in device_us.items()} }; "
          f"launches {launches}; phase 19b wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    want = {name: MV * steps for name in kernels}
    if blend_launches(launches) != want:
        raise AssertionError(f"--profile launched {launches}, not {want}")
    check_sampler(launches, "--profile")
    check_binning(launches, "--profile")
    check_ssim(launches, "--profile")
    check_projection(launches, "--profile")
    for rng in ("binning", "slot_reduce"):
        if not any(e.get("name") == rng for e in events):
            raise AssertionError(f"the trace does not name the {rng} "
                                 "ranges")
    if set(device_us) != {"fwd_kernel", "bwd_kernel"}:
        raise AssertionError("the trace does not name both blend kernels")
    if not sampler_named:
        raise AssertionError("the trace does not name the plane_sample "
                             "ranges")
    return launches


def step_recon_phase(params, state, cfg, args, dev, card: str):
    """19c: tools/profile_step_recon_torch.py's `time_variants` on phase
    7's model and views (mv = 4 at full width).  Returns the launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import profile_step_recon_torch as recon

    t_phase = time.perf_counter()
    tile = raster_v3.TILE if TILE16_DEFAULT else TILE
    cams = orbit_cameras(recon.MV, dev)
    gts = smooth_targets(recon.MV, args.seed, dev)
    cuda_lib.LAUNCHES.clear()
    ms = recon.time_variants(cfg, OptimizationConfig(), params, state, cams,
                             gts, torch.zeros(3, device=dev),
                             camera_extent(cams), RECON_ITERS, dev)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    cost = {k[1:]: ms["full"] - v for k, v in ms.items() if k != "full"}
    print(f"step attribution ({card}): ms/step (CUDA events, mean of "
          f"{RECON_ITERS}) {json.dumps(ms)}; each block's cost (full - "
          f"without it) {json.dumps(cost)}"
          f"; the params a step without the optimizer returns equal its "
          f"input bit for bit; launches {launches}; phase 19c wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    n = len(recon.VARIANTS) * (2 + RECON_ITERS) * recon.MV
    want = {FWD_KERNELS[tile]: n, BWD_KERNELS[tile]: n}
    if blend_launches(launches) != want:
        raise AssertionError(f"the attribution launched {launches}, not "
                             f"{want}")
    check_sampler(launches, "the attribution")
    check_binning(launches, "the attribution")
    check_ssim(launches, "the attribution")
    check_projection(launches, "the attribution")
    return launches


def hard_phase(dev, card: str, tmp: str):
    """19d: the hard protocol's scene, a 600-iteration quality run on it,
    the ablation at 200 iterations and the finalize tool on the run's
    last checkpoint, through the tools' `main`.  Returns the launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import ablation_run_torch
    import finalize_quality_run_torch
    import quality_run_torch
    from splatco_torch.utils import synthetic

    t_phase = time.perf_counter()
    tile = raster_v3.TILE if TILE16_DEFAULT else TILE
    work = os.path.join(tmp, "hard")
    scene = os.path.join(work, "scene")
    shape = ["--views", str(HARD_VIEWS), "--points", str(HARD_POINTS),
             "--width", str(HARD_W), "--height", str(HARD_H)]
    total = collections.Counter()

    # the scene, with each ground-truth render's kmax and clip count
    clips = []
    rasterize0 = synthetic.rasterize

    def rasterize_and_record(*a, **kw):
        out = rasterize0(*a, **kw)
        clips.append((kw["kmax"], int(out[1]["num_clipped"])))
        return out

    synthetic.rasterize = rasterize_and_record
    try:
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        synthetic.write_hard_dataset(scene, n_views=HARD_VIEWS,
                                     n_pts=HARD_POINTS, width=HARD_W,
                                     height=HARD_H, arc_period=2,
                                     device=dev)
        scene_s = time.perf_counter() - t0
    finally:
        synthetic.rasterize = rasterize0
    total.update(cuda_lib.LAUNCHES)
    print(f"hard scene ({card}): {HARD_VIEWS} views at {HARD_W}x{HARD_H}, "
          f"{HARD_POINTS} points, arc_period 2, written in {scene_s:.1f} s;"
          f" ground-truth kmax per view {[k for k, _ in clips]}, clipped "
          f"{sum(c for _, c in clips)}")
    if len(clips) != HARD_VIEWS or any(c for _, c in clips):
        raise AssertionError("a ground-truth view clipped gaussians")

    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    run = quality_run_torch.main(
        ["--hard", "--arc_period", "2", "--iterations", str(HARD_ITERS),
         "--skip_artifacts", "--scene", scene, "--model",
         os.path.join(work, "quality"), "--out",
         os.path.join(work, "quality.json"), *shape])
    torch.cuda.synchronize()
    quality_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    total.update(launches)
    traj = run["trajectory"]
    losses = [m["loss"] for m in traj if "loss" in m]
    evals = [(m["iteration"], m["test_psnr"]) for m in traj
             if "test_psnr" in m]
    events = [m for m in traj if "densify_grown" in m]
    print(f"  quality run --hard ({card}): {HARD_ITERS} iterations in "
          f"{quality_s:.1f} s ({1e3 * run['wall_seconds'] / HARD_ITERS:.1f}"
          f" ms/iteration of training, host clock), test PSNR "
          f"{[(i, round(p, 3)) for i, p in evals]}, final "
          f"{json.dumps(run['final_test'])}, anchors {run['anchors_final']};"
          f" launches {launches}")
    for m in events:
        print(f"    densify @{m['iteration']}: grown {m['densify_grown']}, "
              f"pruned {m['densify_pruned']}, marked by CVPM "
              f"{m['cvpm_marked']}, dropped {m['densify_dropped']} -> "
              f"{m['anchors_after']} anchors")
    if not losses or not all(v is not None and math.isfinite(v)
                             for v in losses):
        raise AssertionError("a logged loss is not finite")
    if not evals[-1][1] > evals[0][1]:
        raise AssertionError(f"test PSNR did not rise: {evals}")
    if launches.get(BWD_KERNELS[tile]) != run["config"]["mv"] * HARD_ITERS:
        raise AssertionError(f"the quality run launched {launches}")
    check_binning(launches, "the quality run")
    check_ssim(launches, "the quality run")
    check_projection(launches, "the quality run")

    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    ablation = ablation_run_torch.main(
        ["--hard", "--arc_period", "2", "--iterations", str(ABLATION_ITERS),
         "--work", work, "--out", os.path.join(work, "ablation.json"),
         *shape])
    torch.cuda.synchronize()
    total.update(cuda_lib.LAUNCHES)
    variants = ablation["variants"]
    print(f"  ablation ({card}): {ABLATION_ITERS} iterations a variant, "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{n} {json.dumps(v['final_test'])} dynamics "
              f"{v.get('dynamics')}" for n, v in variants.items()))
    if list(variants) != list(ablation_run_torch.VARIANTS) or not all(
            math.isfinite(x) for v in variants.values()
            for x in v["final_test"].values()):
        raise AssertionError("the ablation's variants are not all finite")

    cuda_lib.LAUNCHES.clear()
    fin = finalize_quality_run_torch.main(
        ["--scene", scene, "--model", os.path.join(work, "quality"),
         "--out", os.path.join(work, "final.json"),
         "--iterations", str(HARD_ITERS), "--skip_artifacts", *shape])
    torch.cuda.synchronize()
    total.update(cuda_lib.LAUNCHES)
    rel = max(abs(fin["final_test"][k] - v) / max(abs(v), 1e-12)
              for k, v in run["final_test"].items())
    print(f"  finalize ({card}): restored iteration "
          f"{fin['finalized_from_checkpoint']}, final "
          f"{json.dumps(fin['final_test'])} (largest relative difference "
          f"to the run's {rel:.2e}), {len(fin['trajectory'])} progress "
          f"lines and {len(fin['events'])} events from the log; phase 19d "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    if fin["finalized_from_checkpoint"] != HARD_ITERS or rel > 1e-6:
        raise AssertionError("the finalized payload is not the run's")
    return dict(total)


def last_paths_phase(args, dev, card: str, tmp: str, scene_dir: str,
                     model_dir: str, params, state, cfg):
    """Phase 19 (19a-d); returns the main paths' launches."""
    t_phase = time.perf_counter()
    total = collections.Counter()
    total.update(viewer_phase(args, dev, card, tmp, scene_dir, model_dir))
    total.update(profile_cli_phase(args, card, tmp, scene_dir, model_dir))
    total.update(step_recon_phase(params, state, cfg, args, dev, card))
    total.update(hard_phase(dev, card, tmp))
    print(f"phase 19 ({card}): {time.perf_counter() - t_phase:.1f} s, "
          f"launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------------
# phase 20: the tri-plane sampler's kernels (ops/plane_sample.py)


def same_floats(a: torch.Tensor, b: torch.Tensor) -> bool:
    return same_bits(a.cpu().numpy(), b.cpu().numpy())


def sampler_case(size: int, seed: int, dev, one_cell: bool = False):
    """A plane [SAMPLER_R, size, size], coordinates of SAMPLER_ROWS rows
    (a quarter inside [-1, 1], a quarter over [-1.5, 1.5], so partly off
    the plane, and half at one point, as a regrown model's zero padding
    rows are; with `one_cell` all at that point), strided columns as
    `_split_coords` gives them, and a cotangent [rows, SAMPLER_R] (with
    `one_cell`, every |g| the largest float32 below 16, one sign a
    channel)."""
    rng = np.random.default_rng(seed)
    n, q = SAMPLER_ROWS, SAMPLER_ROWS // 4
    spread = 0 if one_cell else q
    uv = np.concatenate([rng.uniform(-1.0, 1.0, (spread, 3)),
                         rng.uniform(-1.5, 1.5, (spread, 3)),
                         np.tile([0.0123, -0.4567, 0.0], (n - 2 * spread, 1))])
    g = rng.normal(size=(n, SAMPLER_R))
    if one_cell:
        top = float(np.nextafter(np.float32(16.0), np.float32(0.0)))
        g = np.tile(np.where(np.arange(SAMPLER_R) % 2 == 0, top, -top), (n, 1))

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    uv = dev32(uv)
    return (dev32(rng.normal(size=(SAMPLER_R, size, size)) * 0.1),
            uv[:, 0], uv[:, 1], dev32(g))


def corner_cells(u, v, h: int, w: int):
    """[4 N]: each (row, corner)'s flat texel, or h * w off the plane."""
    cell = plane_sample._cell(u, v, h, w)
    cells = []
    for k in range(4):
        _, inb, idx = plane_sample._corner(cell, k, h, w)
        cells.append(torch.where(inb, idx, h * w))
    return torch.stack(cells, dim=1).reshape(-1)


def sampler_bounds(plane, u, v):
    """(forward, backward) bounds at these inputs: the function's own
    work, each input read once and each output written once, the texels
    gathered counted once per distinct texel the rows' corners reach;
    fp32 operations (the forward's cell, weights and four products a row
    and channel; the backward's scaled product per corner and channel,
    the coordinates' gradients, the texels' conversions)."""
    r, h, w = plane.shape
    n = u.shape[0]
    cells = corner_cells(u, v, h, w)
    texels = int(torch.unique(cells[cells < h * w]).numel())
    fwd_bytes = 8 * n + 4 * r * texels + 4 * n * r
    bwd_bytes = 4 * n * r + 8 * n + 4 * r * texels + 4 * r * h * w + 8 * n
    fwd = bound(fwd_bytes, n * 12 + n * r * 11)
    bwd = bound(bwd_bytes, 4 * n * r * 3 + n * r * 12 + n * 14
                + 2 * r * h * w)
    print(f"  sampler work at {h}x{w}: {n} rows, R {r}, {texels} distinct "
          f"texels reached; forward {fwd_bytes} bytes, bound "
          f"{fwd[0]:.5f} ms ({fwd[1]}); backward {bwd_bytes} bytes, "
          f"bound {bwd[0]:.5f} ms ({bwd[1]})")
    return fwd, bwd


def device_split(fn, iters: int) -> dict:
    """Per call of fn, by kernel or memset name (torch.profiler, after a
    warm-up call and a warm-up step of the profiler): (device µs a launch,
    launches a call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=iters),
            acc_events=True) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation and e.count:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0] or e.key
            us, k = out.get(name, (0.0, 0))
            out[name] = (us + e.self_device_time_total, k + e.count)
    return {name: (us / k, k / iters) for name, (us, k) in out.items()}


def split_text(split: dict) -> str:
    return ", ".join(f"{k.strip()} {us:.3f} µs x{n:g}"
                     for k, (us, n) in sorted(split.items()))


def sampler_checks(dev, card: str, seed: int):
    """20a-b: the sampler's kernels against their plain versions at full
    width on `sampler_case`'s inputs (and every row at one cell), then
    timed beside their plain versions and torch's grid_sample (the
    library yardstick: its backward sums with float atomics; timed, never
    used).  Returns the numbers of each kernel's `kernels` entry (the
    first size's, every size's in `modes`)."""
    numbers = {name: {"modes": {}} for name in SAMPLER}
    cases = [(size, False) for size in SAMPLER_SIZES]
    cases.append((SAMPLER_SIZES[0], True))
    for size, one_cell in cases:
        plane, u, v, g = sampler_case(size, seed + size, dev, one_cell)
        n = u.shape[0]
        out = plane_sample.plane_sample_fwd(plane, u, v)
        want = plane_sample.plane_sample_fwd_plain(plane, u, v)
        fwd_err = float((out - want).abs().max())
        got = plane_sample.plane_sample_bwd(g, u, v, plane)
        again = plane_sample.plane_sample_bwd(g, u, v, plane)
        plain = plane_sample.plane_sample_bwd_plain(g, u, v, plane)
        bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        repeat = all(same_floats(a, b) for a, b in zip(got, again))
        exact = [same_floats(a, b) for a, b in zip(got, plain)]
        grid = torch.stack([v, u], -1)[None, None]  # [1, 1, N, 2]: x on W
        lib = torch.nn.functional.grid_sample(
            plane[None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        lib_err = float((lib[0, :, 0].T - want).abs().max())
        what = (f"{size}x{size}, every row at one cell, |g| "
                f"{float(g.abs().max()):.9g}" if one_cell
                else f"{size}x{size}")
        print(f"20a. sampler at {what}, {n} rows, R {SAMPLER_R}: forward "
              f"bit for bit {same_floats(out, want)} (max |d| "
              f"{fwd_err:.3e}); backward d_plane / d_u / d_v bit for bit "
              f"{exact[0]} / {exact[1]} / {exact[2]} (max |d| "
              f"{bwd_err:.3e}); two launches bit for bit {repeat}; "
              f"grid_sample vs plain max |d| {lib_err:.3e}; d_plane "
              f"max |value| {float(got[0].abs().max()):.6g}")
        if not same_floats(out, want):
            raise AssertionError(f"{SAMPLER[0]} disagrees with its plain "
                                 f"version at {what}")
        if not (all(exact) and repeat):
            raise AssertionError(f"{SAMPLER[1]} disagrees with its plain "
                                 f"version at {what} or does not repeat")
        if one_cell:
            continue

        fwd_bound_, bwd_bound_ = sampler_bounds(plane, u, v)
        g_lib = g.T.contiguous()[None, :, None, :]  # [1, R, 1, N]
        plane_req = plane.detach().requires_grad_()
        grid_req = grid.detach().requires_grad_()

        def lib_both():
            y = torch.nn.functional.grid_sample(
                plane_req[None], grid_req, mode="bilinear",
                padding_mode="zeros", align_corners=True)
            return torch.autograd.grad(y, (plane_req, grid_req), g_lib)

        uv_req = torch.stack([u, v], 1).requires_grad_()

        def both():  # one sampled plane, forward and backward
            y = plane_sample.sample_plane(plane_req, uv_req[:, 0],
                                          uv_req[:, 1])
            return torch.autograd.grad(y, (plane_req, uv_req), g)

        def bwd():
            return plane_sample.plane_sample_bwd(g, u, v, plane)

        ms = {
            "fwd": cuda_time_ms(lambda: plane_sample.plane_sample_fwd(
                plane, u, v), SAMPLER_ITERS),
            "bwd": cuda_time_ms(bwd, SAMPLER_ITERS),
            "both": cuda_time_ms(both, SAMPLER_ITERS),
            "fwd_plain": cuda_time_ms(
                lambda: plane_sample.plane_sample_fwd_plain(plane, u, v), 5),
            "bwd_plain": cuda_time_ms(
                lambda: plane_sample.plane_sample_bwd_plain(g, u, v, plane),
                2),
            "fwd_lib": cuda_time_ms(
                lambda: torch.nn.functional.grid_sample(
                    plane[None], grid, mode="bilinear",
                    padding_mode="zeros", align_corners=True),
                SAMPLER_ITERS),
            "bwd_lib": cuda_time_ms(
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    g_lib, plane[None], grid, 0, 0, True, [True, True]),
                SAMPLER_ITERS),
            "both_lib": cuda_time_ms(lib_both, SAMPLER_ITERS)}
        passes = device_split(bwd, SAMPLER_ITERS)
        round_ = device_split(both, SAMPLER_ITERS)
        keys = corner_cells(u, v, size, size).to(torch.int32)
        sort = device_split(lambda: torch.sort(keys, stable=True),
                            SAMPLER_ITERS)
        print(f"20b. {size}x{size} ({card}, CUDA events): forward kernel "
              f"{ms['fwd']:.5f} ms, backward kernels {ms['bwd']:.5f} ms, "
              f"sample_plane forward + backward through autograd "
              f"{ms['both']:.5f} ms; plain on the card "
              f"{ms['fwd_plain']:.4f} / {ms['bwd_plain']:.4f} ms; "
              f"grid_sample forward {ms['fwd_lib']:.5f} ms, its backward "
              f"(grid_sampler_2d_backward) {ms['bwd_lib']:.5f} ms, forward "
              f"+ backward through autograd {ms['both_lib']:.5f} ms")
        print(f"  the backward's passes (torch.profiler, µs a launch, "
              f"launches a call; place_entries and tile_sums start before "
              f"the kernel ahead of them ends, so their spans overlap): "
              f"{split_text(passes)}")
        print(f"  one plane's forward + backward through autograd "
              f"launches {sum(k for _, k in round_.values()):g} kernels "
              f"and memsets: {split_text(round_)}; the stable sort of its "
              f"{keys.numel()} corner cells, which the sampler needed "
              f"before its backward summed integers, launches "
              f"{sum(k for _, k in sort.values()):g}: {split_text(sort)}")
        for name, err, kind, bnd in ((SAMPLER[0], fwd_err, "fwd", fwd_bound_),
                                     (SAMPLER[1], bwd_err, "bwd",
                                      bwd_bound_)):
            rec = {"max_abs_err": err, "ms": ms[kind],
                   "plain_ms": ms[f"{kind}_plain"], "bound_ms": bnd[0],
                   "bound_by": bnd[1], "library_ms": ms[f"{kind}_lib"]}
            if kind == "bwd":
                rec["passes_us"] = {k.strip(): us
                                    for k, (us, _) in passes.items()}
            numbers[name]["modes"][f"{size}x{size}"] = rec
            if size == SAMPLER_SIZES[0]:
                numbers[name].update(err=err, ms=ms[kind], bound=bnd,
                                     plain_ms=ms[f"{kind}_plain"],
                                     library_ms=ms[f"{kind}_lib"])
    return numbers


def padding_question(model_dir: str, dev, card: str):
    """20c: phase 16's trained, regrown state (chkpnt TRAIN_CKPT: capacity
    131,072, zero padding rows past the active anchors).  The sampler's
    forward and backward over the planes of level 0 (what phase 16's
    steps sample) and of level 2 (all 12), timed with the plain version
    through autograd (the path before these kernels: `index_put_` in the
    backward), with the kernels, and with either on the active rows
    alone: does the padding explain the plain backward's time?"""
    tree, meta = load_train_state(model_dir, TRAIN_CKPT, device=dev)
    params, active = tree["params"], tree["active"].bool()
    contractor = Contractor(
        xyz_min=torch.tensor(meta["contractor_min"], device=dev),
        xyz_max=torch.tensor(meta["contractor_max"], device=dev),
        enabled=bool(meta["contractor_enabled"]))
    planes = params["planes"]
    with torch.no_grad():
        xyz = anchor_plane_coords(params, contractor)
        level0 = planes["grids"][0]
        att = apply_tpa(planes["tpa"], torch.cat(
            [level0["xy"], level0["xz"], level0["yz"]], dim=0))
    r = level0["xy"].shape[0]
    sampled = [att[:r], att[r:2 * r], att[2 * r:]]
    for grid_ in planes["grids"]:
        sampled += [grid_["xy"], grid_["xz"], grid_["yz"]]
    # (plane, coordinate columns) in sample_level_feats' pairing
    pairs = [(0, 1), (0, 2), (1, 2)]
    jobs = [(p.detach().clone().requires_grad_(), pairs[i % 3])
            for i, p in enumerate(sampled)]
    gen = torch.Generator(device=dev).manual_seed(0)
    pad = int((~active).sum())
    pad_cells = len(torch.unique(xyz[~active], dim=0)) if pad else 0
    times = {}
    for rows_name, rows in (("all rows", slice(None)),
                            ("active rows", active)):
        coords = [c.detach().clone().requires_grad_()
                  for c in _split_coords(xyz[rows])]
        cot = torch.randn((coords[0].shape[0], r), generator=gen,
                          device=dev)
        for level, count in ((0, planes_sampled(0)), (2, len(jobs))):
            todo = jobs[:count]
            leaves = [p for p, _ in todo] + coords
            for name, fn in (("plain", plane_sample.plane_sample_fwd_plain),
                             ("kernels", plane_sample.sample_plane)):

                def run():
                    outs = [fn(p, coords[a], coords[b]) for p, (a, b) in todo]
                    return torch.autograd.grad(outs, leaves,
                                               [cot] * len(outs))

                times[(rows_name, level, name)] = cuda_time_ms(run, 3)
    print(f"20c. phase 16's state at iteration {meta['iteration']} "
          f"({card}): capacity {active.numel()}, {int(active.sum())} "
          f"active anchors, {pad} padding rows at {pad_cells} distinct "
          f"point(s); the sampler's forward + backward ms (CUDA events, "
          f"mean of 3): " + "; ".join(
              f"level {lv} ({planes_sampled(0) if lv == 0 else len(jobs)} "
              f"planes) {rn}: plain {times[(rn, lv, 'plain')]:.3f}, kernels "
              f"{times[(rn, lv, 'kernels')]:.3f}"
              for rn in ("all rows", "active rows") for lv in (0, 2)))
    return times


def sampler_phase(dev, card: str, seed: int, model_dir: str):
    """Phase 20: 20a-b `sampler_checks`, 20c `padding_question`.
    Returns the kernels' numbers."""
    t_phase = time.perf_counter()
    numbers = sampler_checks(dev, card, seed)
    padding_question(model_dir, dev, card)
    print(f"  phase 20 wall {time.perf_counter() - t_phase:.1f} s")
    return numbers


# ---------------------------------------------------------------------
# phase 21: the tile binning's kernels and the slot reduce


def binning_inputs(fn):
    """Runs fn() with rasterize's `bin_frame` wrapped: the arguments of
    its first binning, (proj, colors, opacities, tile, h, w, kmax),
    copied."""
    seen = []
    bin_frame0 = rasterize_ops.bin_frame

    def capture(proj, colors, opacities, *rest, **kw):
        if not seen:
            seen.append((ProjectedCols(*(t.clone() for t in proj)),
                         colors.clone(), opacities.clone(), *rest))
        return bin_frame0(proj, colors, opacities, *rest, **kw)

    rasterize_ops.bin_frame = capture
    try:
        fn()
    finally:
        rasterize_ops.bin_frame = bin_frame0
    return seen[0]


def rendered_inputs(params, active, contractor, cam, cfg, level: int,
                    kmax: int, tile16: bool):
    """The binning's inputs of a `render` of this state and camera."""
    dev = active.device

    def run():
        with torch.inference_mode():
            vis = prefilter_voxel(params["anchors"], active, cam)
            render(params, active, contractor, cam, torch.zeros(3, device=dev),
                   visible_mask=vis, activate_level=level, kmax=kmax,
                   tile16=tile16, **decode_kwargs(cfg))
    return binning_inputs(run)


def hot_tile_inputs(seed: int, dev, tile16: bool, kmax: int, n: int):
    """n gaussians inside 16 px tile (2, 2) (so 32 px tile (1, 1)),
    radius 3, depths on a grid of 0.01 (ties): one segment of n
    records."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    proj = ProjectedCols(mx=u(36.0, 44.0), my=u(36.0, 44.0),
                         depth=torch.round(u(1.0, 3.0) * 100) / 100,
                         ca=torch.full((n,), 0.4), cb=u(-0.05, 0.05),
                         cc=torch.full((n,), 0.4),
                         radius=torch.full((n,), 3.0))
    return (ProjectedCols(*(t.to(dev) for t in proj)),
            torch.rand((n, 3), generator=g).to(dev), u(0.2, 0.99).to(dev),
            tile_of(tile16), HEIGHT, WIDTH, kmax)


def mixed_warp_inputs(seed: int, dev, tile16: bool, kmax: int,
                      n: int = MIXED_N):
    """n gaussians where every warp of 32 rows mixes radius-0 rows (every
    third), rects far wider than kmax tiles (clipped around their centre;
    row 0's at the image centre), narrow ones and gaussians off the
    image, at sharp and flat orientations: what the slot-parallel
    enumeration must hand out.  Every 99th row from row 4 meets torch's
    NaN rules in the reach test (`nonfinite_rows`).  The rows do not
    depend on tile16 or kmax."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    row = torch.arange(n)
    sig = torch.where(row % 3 == 0, u(40.0, 160.0), u(0.5, 6.0))
    th = u(0.0, math.pi)
    c, s = torch.cos(th), torch.sin(th)
    squash = u(0.05, 1.0)
    a = c * c * sig * sig + s * s * (sig * squash) ** 2 + 0.3
    b = c * s * (sig * sig - (sig * squash) ** 2)
    d = s * s * sig * sig + c * c * (sig * squash) ** 2 + 0.3
    det = a * d - b * b
    radius = torch.where(row % 3 == 2, 0.0, torch.ceil(3.0 * sig))
    mx, my = u(-200.0, WIDTH + 200.0), u(-200.0, HEIGHT + 200.0)
    mx[0], my[0] = WIDTH / 2, HEIGHT / 2
    proj = ProjectedCols(mx=mx, my=my,
                         depth=torch.round(u(1.0, 3.0) * 20) / 20,
                         ca=d / det, cb=-b / det, cc=a / det, radius=radius)
    opac = u(0.05, 0.99)
    proj, opac = nonfinite_rows(proj, opac, range(4, n, 99))
    return (ProjectedCols(*(t.to(dev) for t in proj)),
            torch.rand((n, 3), generator=g).to(dev), opac.to(dev),
            tile_of(tile16), HEIGHT, WIDTH, kmax)


def nonfinite_rows(proj, opac, rows):
    """proj and opacities with each of `rows` (rows with a rect) made one
    of four cases of torch's NaN rules in the reach test, in turn: conic
    terms whose edge sums overflow to inf - inf (NaN), an infinite cross
    term with the centre on a tile edge (inf * 0), an infinite cross term
    of the other sign, and a NaN opacity (a NaN bound on every tile).
    The records keep only finite or infinite values."""
    ca, cb, cc, mx = (t.clone() for t in (proj.ca, proj.cb, proj.cc,
                                           proj.mx))
    opac = opac.clone()
    for k, r in enumerate(rows):
        kind = k % 4
        if kind == 0:
            ca[r], cb[r], cc[r] = 3e32, -2.9e32, 3e32
        elif kind == 1:
            cb[r], mx[r] = math.inf, 64.0 * round(float(mx[r]) / 64.0)
        elif kind == 2:
            cb[r] = -math.inf
        else:
            opac[r] = math.nan
    return proj._replace(mx=mx, ca=ca, cb=cb, cc=cc), opac


def same_tensors(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


def binning_bounds(inputs, counts, slot_mask, pairs: int):
    """Each kernel's bound on these inputs (bytes: each input read once,
    each output written once; fp32 operations of the reach tests the
    clipped rects need), the bounds of the sort and the reduce as they
    were counted when the slot map was dense, and the work counted.  A
    gaussian of radius 0 (padding, or culled) needs only its radius
    read: 4 B, where one with a rect reads its 6 other columns (7a) and
    its depth (7b) too.  7c reads the keys, the tile ranges and 9 columns
    of each gaussian with pairs, and writes 36 B of record, 8 B of
    gauss_id and 4 B of slot map a pair and the slot mask (4 B a word of
    a gaussian); 7d reads the mask, 4 B of map and 36 B of record a pair
    and writes 36 B a gaussian, 9 adds a pair.  Before, both charged the
    whole int32 map, 4 * kmax * N B, and 7d 9 * kmax * N adds."""
    proj, _, _, tile, h, w, kmax = inputs
    tiles_x, tiles_y = grid(tile == raster_v3.TILE, h, w)
    n, t = proj.mx.shape[0], tiles_x * tiles_y
    slots = int(binning._rects(proj.mx, proj.my, proj.radius, tile, tiles_x,
                               tiles_y, kmax)[3].clamp_max(kmax).sum())
    live = int((proj.radius > 0).sum())
    used = int((slot_mask != 0).any(dim=0).sum())
    mask_bytes = 4 * slot_mask.numel()
    ops = OPS_PER_GAUSSIAN * live + OPS_PER_SLOT * slots
    sort_io = 8 * pairs + 8 * t + 36 * used + 44 * pairs
    return {
        binning.COUNT_KERNEL: bound(4 * n + 24 * live + 8 * t + 32, ops),
        binning.PLACE_KERNEL: bound(4 * n + 28 * live + 4 * t + 8 * pairs,
                                    ops),
        binning.SORT_KERNEL: bound(sort_io + 4 * pairs + mask_bytes, 0),
        REDUCE_KERNEL: bound(mask_bytes + 40 * pairs + 36 * n, 9 * pairs),
    }, {
        binning.SORT_KERNEL: bound(sort_io + 4 * kmax * n, 0),
        REDUCE_KERNEL: bound(4 * kmax * n + 36 * pairs + 36 * n,
                             9 * kmax * n),
    }, {"slots_tested": slots, "gaussians_with_rects": live,
        "gaussians_with_pairs": used}


def binning_case(what: str, inputs, seed: int, timed: bool):
    """21a-b on one case: each kernel twice against its plain version,
    bit for bit (bin_place as the keys of each segment, the sort's map
    under the mask), the composed binning against the plain one, and,
    when `timed`, each kernel, its plain version and the library call
    beside its bound, and the sort's and the reduce's device operations.
    Returns ({kernel: numbers}, the longest segment)."""
    proj, colors, op, tile, h, w, kmax = inputs
    tiles_x, tiles_y = grid(tile == raster_v3.TILE, h, w)
    geo = (tile, tiles_x, tiles_y, kmax, tile == raster_v3.TILE)
    dev = proj.mx.device
    n = proj.mx.shape[0]

    counts = [binning.bin_count(proj, op, *geo) for _ in range(2)]
    want_counts = binning.bin_count_plain(proj, op, *geo)
    start, end, stats = want_counts
    pairs, longest = stats[2:].tolist()
    keys = [binning.bin_place(proj, op, start, pairs, *geo)
            for _ in range(2)]
    want_keys = binning.bin_place_plain(proj, op, start, pairs, *geo)
    sorted_want = binning.sort_segments_plain(want_keys, start, end)
    outs = [binning.bin_sort_tiles(k.clone(), start, end, longest, proj,
                                   colors, op, kmax)
            for k in (keys[0], keys[1], want_keys)]
    want_out = binning.bin_sort_tiles_plain(want_keys, start, end, proj,
                                            colors, op, kmax)
    slot_pos, slot_mask = outs[0].slot_pos, outs[0].slot_mask  # the card's
    g = torch.Generator(device=dev).manual_seed(seed)
    per_rec = torch.randn((binning.NUM_REC, pairs), generator=g, device=dev)
    per_rec[:, ::5] = -0.0  # an empty slot adds +0.0 (the kernel skips it)
    sums = [reduce_slots(per_rec, slot_pos, slot_mask) for _ in range(2)]
    want_sums = reduce_slots_plain(per_rec, want_out.slot_pos,
                                   want_out.slot_mask)
    got = bin_frame(proj, colors, op, tile, h, w, kmax)[0]
    plain = binning.bin_gaussians_plain(proj, colors, op, *geo)
    torch.cuda.synchronize()
    exact = {
        binning.COUNT_KERNEL: all(same_tensors(c, want_counts)
                                  for c in counts),
        binning.PLACE_KERNEL: all(same_tensors(
            [binning.sort_segments_plain(k, start, end)], [sorted_want])
            for k in keys),
        binning.SORT_KERNEL: all(not binning.binning_diff(o, want_out)
                                 for o in outs),
        REDUCE_KERNEL: all(same_tensors([x], [want_sums]) for x in sums),
        "bin_frame": not binning.binning_diff(got, plain),
    }
    in_order = same_tensors([keys[0]], [want_keys])
    err = {binning.COUNT_KERNEL: max(
               float((c - p).abs().max()) if c.numel() else 0.0
               for c, p in zip(counts[0], want_counts)),
           binning.PLACE_KERNEL: 0.0 if exact[binning.PLACE_KERNEL]
           else float("inf"),
           binning.SORT_KERNEL: max(
               float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               if a.numel() else 0.0 for a, b in zip(
                   outs[0]._replace(
                       slot_pos=binning.defined_slot_pos(outs[0])),
                   want_out)),
           REDUCE_KERNEL: float((sums[0] - want_sums).abs().max())
           if want_sums.numel() else 0.0}
    print(f"21a. {what}: N {n}, kmax {kmax}, {tile} px tiles, {pairs} "
          f"pairs, longest segment {longest}, num_clipped "
          f"{int(stats[0])}, max_slots {int(stats[1])}; bit for bit with "
          f"the plain versions (two launches each; bin_place as each "
          f"segment's keys, its own order equal {in_order}): "
          f"{json.dumps(exact)}")
    if not all(exact.values()):
        raise AssertionError(f"a binning kernel disagrees with its plain "
                             f"version on {what}: {exact}")
    if not timed:
        return {}, longest
    bnds, before, work = binning_bounds(inputs, want_counts, slot_mask,
                                        pairs)
    sort_keys = keys[0].clone()
    seg = torch.repeat_interleave(torch.arange(tiles_x * tiles_y, device=dev),
                                  (end - start).to(torch.int64))
    lib_key = (seg << 32) | (want_keys >> 32)  # tile << 32 | depth bits
    gid = want_out[1]
    ms = {
        binning.COUNT_KERNEL: (
            cuda_time_ms(lambda: binning.bin_count(proj, op, *geo),
                         BIN_ITERS),
            cuda_time_ms(lambda: binning.bin_count_plain(proj, op, *geo), 3),
            None),
        binning.PLACE_KERNEL: (
            cuda_time_ms(lambda: binning.bin_place(proj, op, start, pairs,
                                                   *geo), BIN_ITERS),
            cuda_time_ms(lambda: binning.bin_place_plain(
                proj, op, start, pairs, *geo), 3),
            None),
        # each run overwrites the keys (a long segment's chunks sorted in
        # place, then merged): the network and the merge do the same work
        binning.SORT_KERNEL: (
            cuda_time_ms(lambda: binning.bin_sort_tiles(
                sort_keys, start, end, longest, proj, colors, op, kmax),
                BIN_ITERS),
            cuda_time_ms(lambda: binning.bin_sort_tiles_plain(
                want_keys, start, end, proj, colors, op, kmax), 3),
            cuda_time_ms(lambda: torch.argsort(lib_key, stable=True),
                         BIN_ITERS)),
        REDUCE_KERNEL: (
            cuda_time_ms(lambda: reduce_slots(per_rec, slot_pos, slot_mask),
                         BIN_ITERS),
            cuda_time_ms(lambda: reduce_slots_plain(per_rec, slot_pos,
                                                    slot_mask), 3),
            cuda_time_ms(lambda: torch.zeros(
                (binning.NUM_REC, n), device=dev).index_add_(1, gid, per_rec),
                BIN_ITERS)),
    }
    whole = (cuda_time_ms(lambda: bin_frame(proj, colors, op, tile, h, w,
                                            kmax), BIN_ITERS),
             cuda_time_ms(lambda: binning.bin_gaussians_plain(
                 proj, colors, op, *geo), 3))
    split = {
        binning.COUNT_KERNEL: device_split(
            lambda: binning.bin_count(proj, op, *geo), BIN_ITERS),
        binning.PLACE_KERNEL: device_split(
            lambda: binning.bin_place(proj, op, start, pairs, *geo),
            BIN_ITERS),
        binning.SORT_KERNEL: device_split(lambda: binning.bin_sort_tiles(
            sort_keys, start, end, longest, proj, colors, op, kmax),
            BIN_ITERS),
        REDUCE_KERNEL: device_split(
            lambda: reduce_slots(per_rec, slot_pos, slot_mask), BIN_ITERS)}

    def was(k):
        return (f", dense-map bound {before[k][0]:.5f}" if k in before
                else "")
    print(f"21b. {what} (CUDA events, ms): " + "; ".join(
        f"{k} {m[0]:.5f} (bound {bnds[k][0]:.5f}, {bnds[k][1]}{was(k)}; "
        f"plain {m[1]:.4f}; library "
        f"{'none' if m[2] is None else f'{m[2]:.5f}'})"
        for k, m in ms.items())
        + f"; the binning through bin_frame {whole[0]:.5f} (its read-back "
        f"of P included), plain {whole[1]:.4f}; work {json.dumps(work)}")
    for k, ops in split.items():
        print(f"  {k}'s device operations (torch.profiler): "
              f"{split_text(ops)}")
    return {k: {"max_abs_err": err[k], "ms": m[0], "plain_ms": m[1],
                "bound_ms": bnds[k][0], "bound_by": bnds[k][1],
                "library_ms": m[2], "pairs": pairs, "longest": longest,
                "n": n, "kmax": kmax,
                **({"bound_ms_dense_map": before[k][0]} if k in before
                   else {})}
            for k, m in ms.items()}, longest


def binning_stage_turns(params, state, cfg, cam, tile16: bool):
    """21c: frame 0's binning stage (frame_stages, CUDA events) with the
    kernels and with the plain versions, in turns plain, kernels,
    kernels, plain after a warm-up of each."""
    level = 2
    ms = {True: [], False: []}
    with torch.inference_mode():
        for plain in (True, False):
            frame_stages(params, state, cam, cfg, level, tile16, plain)
        for plain in (True, False, False, True):
            ms[plain].append(frame_stages(params, state, cam, cfg, level,
                                          tile16, plain)[1]["binning"])
    print(f"21c. frame 0's binning stage ({tile_of(tile16)} px tiles, kmax "
          f"{cfg.kmax}; turns plain, kernels, kernels, plain): kernels "
          f"{ms[False]} ms, plain {ms[True]} ms")
    return ms


def binning_phase(dev, card: str, seed: int, params, state, cfg, cams,
                  model_dir: str):
    """Phase 21a-c.  21a-b: the binning kernels and the slot reduce
    against their plain versions at frame 0 of the quick-start model (v2,
    kmax 12; v3, kmax 32), at phase 16's iteration-45 state (capacity
    131,072, its padding rows included; kmax 32), on the crafted hot
    tile (v2 and v3) and, untimed, at frame 0 on wide grids (WIDE_FRAMES,
    one past binning.SHARED_TILES), on a crafted tile of LONG_N gaussians
    (v3) and on the crafted mixed warps (v2 at kmax 12, v3 at kmax
    MIXED_KMAX_V3); 21c: frame 0's binning stage with the kernels
    and with the plain versions.  Returns each kernel's numbers (frame 0
    in v2 first, every timed case in `modes`)."""
    t_phase = time.perf_counter()
    cfg3 = dataclasses.replace(cfg, kmax=KMAX_V3)
    tree, meta = load_train_state(model_dir, TRAIN_CKPT, device=dev)
    trained_cfg = load_run_config(model_dir)[0]
    contractor = Contractor(
        xyz_min=torch.tensor(meta["contractor_min"], device=dev),
        xyz_max=torch.tensor(meta["contractor_max"], device=dev),
        enabled=bool(meta["contractor_enabled"]))
    cam16 = orbit_camera(0, DISK_VIEWS, width=WIDTH, height_px=HEIGHT,
                         device=dev)
    cases = [
        ("frame 0, v2", rendered_inputs(params, state.active,
                                        state.contractor, cams[0], cfg, 2,
                                        cfg.kmax, False), True),
        ("frame 0, v3", rendered_inputs(params, state.active,
                                        state.contractor, cams[0], cfg3, 2,
                                        KMAX_V3, True), True),
        (f"phase 16's iteration-{TRAIN_CKPT} state",
         rendered_inputs(tree["params"], tree["active"].bool(), contractor,
                         cam16, trained_cfg, 0, KMAX_V3, TILE16_DEFAULT),
         True),
        ("hot tile, v2", hot_tile_inputs(seed, dev, False, cfg.kmax, HOT_N),
         True),
        ("hot tile, v3", hot_tile_inputs(seed, dev, True, KMAX_V3, HOT_N),
         True),
        (f"a tile of {LONG_N} records, v3",
         hot_tile_inputs(seed, dev, True, KMAX_V3, LONG_N), False),
        (f"mixed warps, v2, kmax {cfg.kmax}",
         mixed_warp_inputs(seed, dev, False, cfg.kmax), False),
        (f"mixed warps, v3, kmax {MIXED_KMAX_V3}",
         mixed_warp_inputs(seed, dev, True, MIXED_KMAX_V3), False),
    ]
    if all(math.prod(grid(tile16, h, w)) <= binning.SHARED_TILES
           for w, h, tile16 in WIDE_FRAMES):
        raise AssertionError("no wide frame passes binning.SHARED_TILES")
    for w, h, tile16 in WIDE_FRAMES:
        tiles_x, tiles_y = grid(tile16, h, w)
        where = ("global" if tiles_x * tiles_y > binning.SHARED_TILES
                 else "shared")
        c = cfg3 if tile16 else cfg
        cases.append((f"frame 0 at {w}x{h}, v{3 if tile16 else 2} "
                      f"({tiles_x * tiles_y} tiles, {where} counters)",
                      rendered_inputs(params, state.active, state.contractor,
                                      orbit_cameras(1, dev, w, h)[0], c, 2,
                                      c.kmax, tile16), False))
    del tree
    numbers = {name: {"modes": {}} for name in BINNING}
    longest = {}
    for what, inputs, timed in cases:
        recs, longest[what] = binning_case(what, inputs, seed, timed)
        for name, rec in recs.items():
            numbers[name]["modes"][what] = rec
    for what, n in (("hot tile, v2", HOT_N), ("hot tile, v3", HOT_N),
                    (f"a tile of {LONG_N} records, v3", LONG_N)):
        if longest[what] != n:
            raise AssertionError(f"the {what} scene is not one segment of "
                                 f"{n} records")
    for name in BINNING:
        first = numbers[name]["modes"]["frame 0, v2"]
        numbers[name].update(err=first["max_abs_err"], ms=first["ms"],
                             plain_ms=first["plain_ms"],
                             bound=(first["bound_ms"], first["bound_by"]),
                             library_ms=first["library_ms"])
    for tile16, c in ((False, cfg), (True, cfg3)):
        binning_stage_turns(params, state, c, cams[0], tile16)
    print(f"  phase 21a-c wall {time.perf_counter() - t_phase:.1f} s")
    return numbers


def binning_launch_table(phase_launches: dict):
    """21d: the binning kernels' and the slot reduce's launches on each
    phase's main path (each phase's own check held them to its blend
    launches); every phase binned through the kernels."""
    table = {phase: {k: launches.get(k, 0) for k in BINNING}
             for phase, launches in phase_launches.items()}
    print(f"21d. the binning kernels' launches on each phase's main path: "
          f"{json.dumps(table)}")
    for phase, got in table.items():
        if not all(got[k] for k in binning.KERNELS):
            raise AssertionError(f"{phase} did not bin through the kernels")


# ---------------------------------------------------------------------
# phase 22: SSIM's kernels (ops/losses.py: sep_blur, ssim_map_fwd,
# ssim_map_bwd)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape and the same float32 bits (NaNs included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@contextlib.contextmanager
def plain_ssim():
    """SSIM through its plain versions, on whatever device the tensors
    are: the three wrappers swapped for the functions the kernels are
    held to."""
    saved = (loss_ops.sep_blur, loss_ops.ssim_map_fwd, loss_ops.ssim_map_bwd)
    loss_ops.sep_blur = loss_ops._sep_gauss_blur
    loss_ops.ssim_map_fwd = loss_ops._ssim_map_fwd_plain
    loss_ops.ssim_map_bwd = loss_ops._ssim_map_bwd_plain
    try:
        yield
    finally:
        (loss_ops.sep_blur, loss_ops.ssim_map_fwd,
         loss_ops.ssim_map_bwd) = saved


def eval_image_pair(model_dir: str):
    """Phase 17's first test view: its render and its ground truth
    [3, H, W] as metrics_torch.py reads them back from their PNGs."""
    it_dir = os.path.join(model_dir, "test", f"ours_{TRAIN_ITERS}")
    renders, gts, _ = metrics_driver.read_images(
        os.path.join(it_dir, "renders"), os.path.join(it_dir, "gt"))
    return renders[0], gts[0]


def ssim_images(shape, kind, seed: int, dev, eval_pair=None):
    """An image pair [B, C, H, W] as SSIM sees one: a seeded rendered
    view against its target, `eval_pair` (a render and its ground truth
    read from PNG) for kind "png", or a seeded pair with NaN and infinite
    entries."""
    if kind == "png":
        return tuple(torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)
                     for x in eval_pair)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    if kind == "nonfinite":
        flat = a.view(-1)
        idx = torch.randint(0, flat.numel(), (30,), generator=gen,
                            device=dev)
        flat[idx[:10]] = float("nan")
        flat[idx[10:20]] = float("inf")
        flat[idx[20:]] = -float("inf")
    return a, b


def ssim_stack(a, b):
    """`_ssim_map`'s stack of the five moments before the blur."""
    return torch.cat([a, b, a * a, b * b, a * b])


def ssim_value_and_grads(fn, a, b):
    a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = fn(a, b)
    return (out.detach(), *torch.autograd.grad(out, (a, b)))


def ssim_case(what, a, b, seed: int, dev):
    """22a-c on the pair a, b: the blur (and, with B > 1, each of
    BLUR_WINDOWS) twice against its plain version, the map forward and
    backward (a seeded cotangent and a constant one, as `mean` sends)
    twice against theirs, and `ssim` and `masked_ssim` with their
    gradients through the kernels against the plain versions, all on the
    card and bit for bit.  Returns the blurred stack."""
    shape = tuple(a.shape)
    windows = BLUR_WINDOWS if shape[0] > 1 else ()
    stack = ssim_stack(a, b)
    g1d = loss_ops._gaussian_1d(11, 1.5)
    results = {}
    blurred = loss_ops.sep_blur(stack, g1d)
    again = loss_ops.sep_blur(stack, g1d)
    results["sep_blur"] = (bits_equal(blurred, again) and bits_equal(
        blurred, loss_ops._sep_gauss_blur(stack, g1d)))
    for w in windows:
        win = loss_ops._gaussian_1d(w, 1.5)
        results[f"sep_blur[{w} taps]"] = bits_equal(
            loss_ops.sep_blur(stack, win),
            loss_ops._sep_gauss_blur(stack, win))
    fwd = loss_ops.ssim_map_fwd(blurred)
    results["ssim_map_fwd"] = (
        bits_equal(fwd, loss_ops.ssim_map_fwd(blurred))
        and bits_equal(fwd, loss_ops._ssim_map_fwd_plain(blurred)))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    cts = {"seeded": torch.randn(fwd.shape, generator=gen, device=dev)
           / fwd.numel(),
           "constant": torch.full(fwd.shape, 1.0 / fwd.numel(),
                                  device=dev)}
    for name, ct in cts.items():
        got = loss_ops.ssim_map_bwd(ct, blurred)
        results[f"ssim_map_bwd[{name}]"] = (
            bits_equal(got, loss_ops.ssim_map_bwd(ct, blurred))
            and bits_equal(got, loss_ops._ssim_map_bwd_plain(ct, blurred)))
    mask = torch.rand(shape[-2:], generator=gen, device=dev) < 0.7
    for name, fn in (("ssim", ssim),
                     ("masked_ssim", lambda x, y: masked_ssim(x, y, mask))):
        got = ssim_value_and_grads(fn, a, b)
        with plain_ssim():
            want = ssim_value_and_grads(fn, a, b)
        results[f"{name} and grads"] = all(
            bits_equal(x, y) for x, y in zip(got, want))
    torch.cuda.synchronize()
    print(f"22a-c. {what} {list(shape)}: bit for bit "
          f"{json.dumps(results)}")
    if not all(results.values()):
        raise AssertionError(f"SSIM's kernels differ from their plain "
                             f"versions on {what}")
    return blurred


def conv2d_blur(x, g1d):
    """The blur as a depthwise 11x1 then 1x11 `F.conv2d` over x [P, H, W]
    (zero padding, groups = P): one library call a pass, timed only (its
    sums run in another order)."""
    p = x.shape[0]
    k = torch.as_tensor(g1d, device=x.device)
    r = k.numel() // 2
    y = torch.nn.functional.conv2d(
        x[None], k.view(1, 1, -1, 1).expand(p, 1, -1, 1), padding=(r, 0),
        groups=p)
    return torch.nn.functional.conv2d(
        y, k.view(1, 1, 1, -1).expand(p, 1, 1, -1), padding=(0, r),
        groups=p)[0]


def ssim_phase(dev, card: str, seed: int, eval_pair):
    """Phase 22a-c: SSIM's kernels against their plain versions on the
    card, bit for bit, on the cases of SSIM_CASES (the "png" one is
    `eval_pair`, phase 17's first test view); each kernel timed at
    a training view's shapes beside its bound, its plain version and the
    `F.conv2d` pair (the blur's library call).  Returns each kernel's
    numbers."""
    t_phase = time.perf_counter()
    for i, (what, shape, kind) in enumerate(SSIM_CASES):
        a, b = ssim_images(shape, kind, seed + i, dev, eval_pair)
        blurred = ssim_case(what, a, b, seed + i, dev)
        if i == 0:
            view = blurred
    a, b = ssim_images(SSIM_CASES[0][1], None, seed, dev)
    stack = ssim_stack(a, b)
    g1d = loss_ops._gaussian_1d(11, 1.5)
    taps = len(g1d)
    n = view.numel() // 5
    ct = torch.randn(view.shape[0] // 5, *view.shape[1:],
                     generator=torch.Generator(device=dev).manual_seed(seed),
                     device=dev) / n
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the float32 function
    try:
        library = cuda_time_ms(lambda: conv2d_blur(
            stack.view(-1, *stack.shape[2:]), g1d), SSIM_ITERS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    runs = {
        loss_ops.BLUR_KERNEL: (
            lambda: loss_ops.sep_blur(stack, g1d),
            lambda: loss_ops._sep_gauss_blur(stack, g1d),
            bound(8 * stack.numel(), 2 * (2 * taps - 1) * stack.numel()),
            library),
        loss_ops.MAP_FWD_KERNEL: (
            lambda: loss_ops.ssim_map_fwd(view),
            lambda: loss_ops._ssim_map_fwd_plain(view),
            bound(4 * 6 * n, SSIM_FWD_OPS * n), None),
        loss_ops.MAP_BWD_KERNEL: (
            lambda: loss_ops.ssim_map_bwd(ct, view),
            lambda: loss_ops._ssim_map_bwd_plain(ct, view),
            bound(4 * 11 * n, SSIM_BWD_OPS * n), None),
    }
    numbers = {}
    for name, (kernel, plain, bnd, lib) in runs.items():
        err = float((kernel() - plain()).abs().max())
        ms = cuda_time_ms(kernel, SSIM_ITERS)
        plain_ms = cuda_time_ms(plain, SSIM_PLAIN_ITERS)
        numbers[name] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound": bnd, "library_ms": lib}
        print(f"22b. {name} at a training view ({list(view.shape)} "
              f"moments, {card}): max |kernel - plain| {err:.3e}, kernel "
              f"{ms:.5f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})"
              + (f", F.conv2d pair {lib:.5f} ms" if lib is not None
                 else ""))
    print(f"  phase 22a-c wall {time.perf_counter() - t_phase:.1f} s")
    return numbers


def ssim_launch_table(phase_launches: dict, scoring):
    """22d: SSIM's kernels' launches on each phase's main path (each
    phase's own `check_ssim` held them to its forwards and backwards);
    every phase in `scoring` scored through the kernels."""
    table = {phase: {k: launches.get(k, 0) for k in SSIM}
             for phase, launches in phase_launches.items()}
    print(f"22d. SSIM's kernels' launches on each phase's main path: "
          f"{json.dumps(table)}")
    for phase in scoring:
        if not table[phase][loss_ops.MAP_FWD_KERNEL]:
            raise AssertionError(f"{phase} did not score SSIM through the "
                                 "kernels")


# ---------------------------------------------------------------------
# phase 23: the EWA projection's kernels (ops/projection.py: project_fwd,
# project_bwd)


def projection_crafted_cases():
    """The crafted rows phase 23 and the CPU tests hold the projection to,
    as numpy float32: [(what, (means [N, 3], scales [N, 3], quats [N, 4],
    viewmatrix [4, 4], projmatrix [4, 4], width, height, tan_fovx,
    tan_fovy))].  The camera sits at the origin looking down +z (the view
    matrix the identity, so t = p exactly): rows in front, on and behind
    the near plane, at |tz| < 1e-8, with a zero quaternion, zero scales
    (a padding row at capacity), NaN and infinite entries in each input,
    and tx / tz, ty / tz exactly at and just past +-1.3 tan(fov).  The
    second case's view matrix maps x and y alike (a singular view, W = H
    and fovx = fovy), so M's rows are equal and a large gaussian's cov2D
    has det == 0 exactly (the low pass is below its rounding)."""
    fovx, width, height = 1.0, 64, 48
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    tfx, tfy = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = projection_matrix(0.01, 100.0, fovx, fovy).T
    eye = np.eye(4, dtype=np.float32)
    limx, limy = np.float32(1.3 * tfx), np.float32(1.3 * tfy)
    nan, inf = float("nan"), float("inf")
    ok_s, ok_q = (0.05, 0.02, 0.01), (0.9, 0.1, -0.3, 0.2)
    big_s = (0.6, 0.5, 0.4)
    rows = [  # mean, scale, quat
        ((0.1, -0.2, 3.0), ok_s, ok_q),
        ((0.5, 0.3, 1.5), (0.2, 0.2, 0.2), (1.0, 0.0, 0.0, 0.0)),
        ((0.0, 0.0, 0.1), ok_s, ok_q),                 # behind near
        ((0.3, 0.1, -2.0), ok_s, ok_q),                # behind the camera
        ((0.0, 0.0, 0.2), ok_s, ok_q),                 # on the near plane
        ((0.2, 0.1, 0.0), ok_s, ok_q),                 # tz == 0
        ((0.2, 0.1, 5e-9), ok_s, ok_q),                # |tz| < 1e-8
        ((0.2, 0.1, -5e-9), ok_s, ok_q),
        ((0.1, 0.1, 2.0), ok_s, (0.0, 0.0, 0.0, 0.0)),  # zero quaternion
        ((0.1, 0.1, 2.0), (0.0, 0.0, 0.0), ok_q),      # zero scales
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)),  # padding
        # tx / tz, ty / tz at and just past the limits (large enough to
        # reach the screen from there)
        ((2 * limx, 0.1, 2.0), big_s, ok_q),
        ((-2 * limx, 0.1, 2.0), big_s, ok_q),
        ((0.1, 2 * limy, 2.0), big_s, ok_q),
        ((0.1, -2 * limy, 2.0), big_s, ok_q),
        ((np.nextafter(2 * limx, np.float32(9)), 0.1, 2.0), big_s, ok_q),
        ((5.0, -4.0, 2.0), ok_s, ok_q),                # far outside
        ((nan, 0.1, 2.0), ok_s, ok_q),
        ((0.1, 0.1, nan), ok_s, ok_q),
        ((inf, 0.1, 2.0), ok_s, ok_q),
        ((0.1, 0.1, -inf), ok_s, ok_q),
        ((0.1, 0.1, 2.0), (nan, 0.02, 0.01), ok_q),
        ((0.1, 0.1, 2.0), (0.05, inf, 0.01), ok_q),
        ((0.1, 0.1, 2.0), ok_s, (nan, 0.1, -0.3, 0.2)),
        ((0.1, 0.1, 2.0), ok_s, (0.9, inf, -0.3, 0.2)),
        ((0.1, 0.1, 2.0), ok_s, (inf, inf, 0.0, 0.0)),
        ((0.1, 0.1, 2.0), (1e30, 1e30, 1e30), ok_q),   # cov2D overflows
    ]
    cols = [np.array([r[k] for r in rows], np.float32) for k in range(3)]
    singular = np.eye(4, dtype=np.float32)
    singular[0, 1], singular[1, 1] = 1.0, 0.0
    tf = math.tan(0.5)
    big = np.array([[0.1, 0.3, 2.0], [0.0, 0.2, 3.0], [0.3, -0.1, 1.0]],
                   np.float32)
    return [("crafted rows", (*cols, eye, eye @ proj, width, height, tfx,
                              tfy)),
            ("det == 0 under a singular view",
             (big, np.full((3, 3), 1e4, np.float32),
              np.tile(np.float32([0.7, 0.1, 0.5, -0.5]), (3, 1)), singular,
              singular @ projection_matrix(0.01, 100.0, 1.0, 1.0).T, 64, 64,
              tf, tf))]


# 23a's ragged sizes (1, 3, a block less, at and past 128 and 256 rows)
# and the row offsets of its views into larger tensors
PROJ_RAGGED_N = (1, 3, 127, 128, 129, 255, 256, 257, 4097)
PROJ_VIEW_OFFSETS = (0, 1, 3)


def rows_at_offset(arrays, offset: int, dev):
    """Each row array [N, k] (numpy) copied into rows offset.. of a NaN
    tensor [N + offset, k] on `dev`, and returned as the view of those
    rows: contiguous, its storage offset offset·k floats."""
    views = []
    for a in arrays:
        big = torch.full((a.shape[0] + offset, a.shape[1]), float("nan"),
                         device=dev)
        big[offset:] = torch.from_numpy(a).to(dev)
        views.append(big[offset:])
    return tuple(views)


def projection_ragged_cases(dev, seed: int):
    """[(what, inputs)]: seeded rows (means around the origin, scales
    e^N(-3, 1), unnormalised quaternions) seen from 1600x1088, N in
    PROJ_RAGGED_N, each as views PROJ_VIEW_OFFSETS rows into larger
    tensors (means and scales 12 or 36 B in, quaternions 16 or 48)."""
    cam = look_at_camera([0.3, 0.2, -3.0], [0, 0, 0], [0, -1, 0], 1.1, 0.8,
                         WIDTH, HEIGHT, device=dev)
    geom = (cam.world_view_transform, cam.full_proj_transform, WIDTH,
            HEIGHT, cam.tan_fovx, cam.tan_fovy)
    cases = []
    for n in PROJ_RAGGED_N:
        rng = np.random.default_rng(seed + n)
        arrays = (rng.normal(size=(n, 3)).astype(np.float32),
                  np.exp(rng.normal(-3, 1, size=(n, 3))).astype(np.float32),
                  rng.normal(size=(n, 4)).astype(np.float32))
        for offset in PROJ_VIEW_OFFSETS:
            cases.append((f"N {n}, {offset} rows in",
                          (*rows_at_offset(arrays, offset, dev), *geom)))
    return cases


def culled_cotangents(cots, inputs):
    """`cots` zeroed on the rows the projection culls (radius 0), as a
    training step's backward sends them; None stays None."""
    radius = projection_ops.project_fwd(*inputs, radius_only=True)
    return tuple(None if g is None else torch.where(radius > 0, g, 0.0)
                 for g in cots)


def projection_inputs(fn):
    """Runs fn() with `projection.project_fwd` and `project_bwd` wrapped:
    {"inputs": the first full forward's inputs (means, scales, quats, the
    matrices and the geometry)} and, if fn takes a backward, "backward":
    the first backward's (six cotangents, inputs), all copied."""
    seen = {}
    fwd0, bwd0 = projection_ops.project_fwd, projection_ops.project_bwd

    def copied(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def fwd(*args, radius_only=False):
        if not radius_only:
            seen.setdefault("inputs", copied(args))
        return fwd0(*args, radius_only=radius_only)

    def bwd(cots, *args):
        seen.setdefault("backward", (copied(cots), copied(args)))
        return bwd0(cots, *args)

    projection_ops.project_fwd, projection_ops.project_bwd = fwd, bwd
    try:
        fn()
    finally:
        projection_ops.project_fwd, projection_ops.project_bwd = fwd0, bwd0
    return seen


def rendered_projection(params, active, contractor, cam, cfg, level: int):
    """The projection's inputs of a `render` of this state and camera,
    and the prefilter's (the anchors, their base scales as the strided
    [:, :3] slice the prefilter passes, their normalised rotations)."""
    dev = active.device

    def run():
        with torch.inference_mode():
            vis = prefilter_voxel(params["anchors"], active, cam)
            render(params, active, contractor, cam, torch.zeros(3, device=dev),
                   visible_mask=vis, activate_level=level,
                   **decode_kwargs(cfg))
    geom = (cam.world_view_transform, cam.full_proj_transform,
            cam.image_width, cam.image_height, cam.tan_fovx, cam.tan_fovy)
    anchors = params["anchors"]
    prefilter = (anchors["anchor"], torch.exp(anchors["scaling"])[:, :3],
                 normalize(anchors["rotation"], eps=1e-12), *geom)
    return projection_inputs(run)["inputs"], prefilter


def seeded_cotangents(n: int, seed: int, dev):
    """The cotangents a render's backward sends: mx, my and the conic's,
    seeded; none for the depth."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = [torch.randn(n, generator=gen, device=dev) for _ in range(5)]
    return (g[0], g[1], None, g[2], g[3], g[4])


def projection_bytes(n: int, cots=None) -> int:
    """Bytes a launch must move: the forward's 40 B in and 28 B out a
    gaussian (4 B out radius only, cots "radius"); the backward's inputs,
    the cotangents sent and 40 B of gradients."""
    if cots is None:
        return 68 * n
    if cots == "radius":
        return 44 * n
    return (80 + 4 * sum(g is not None for g in cots)) * n


def projection_case(what, inputs, cots_sets, timed: bool):
    """23a on one case: the forward, full and radius only, twice against
    its plain version, and the backward twice against
    `_project_bwd_plain` with each set of `cots_sets` (name -> six [N]
    cotangents, None for zeros), all bit for bit; when `timed`, each
    kernel, its plain version and its bound (the backward with the
    first set).  Returns {name: numbers}."""
    means, scales, quats, vm, pm, *geom = inputs
    fwd = projection_ops.project_fwd
    bwd = projection_ops.project_bwd
    got = fwd(*inputs)
    results = {"project_fwd": (
        bits_equal(got, fwd(*inputs))
        and bits_equal(got, projection_ops._project_fwd_plain(*inputs)))}
    results["project_fwd[radius]"] = bits_equal(
        fwd(*inputs, radius_only=True), got[6])
    for name, cots in cots_sets.items():
        a, b = bwd(cots, *inputs), bwd(cots, *inputs)
        want = projection_ops._project_bwd_plain(cots, *inputs)
        results[f"project_bwd[{name}]"] = all(
            bits_equal(x, y) and bits_equal(x, z)
            for x, y, z in zip(a, b, want))
    torch.cuda.synchronize()
    n = means.shape[0]
    print(f"23a. {what} ({n} gaussians): bit for bit {json.dumps(results)}")
    if not all(results.values()):
        raise AssertionError(f"the projection's kernels differ from their "
                             f"plain versions on {what}")
    if not timed:
        return {}
    cots = next(iter(cots_sets.values()))
    runs = {
        projection_ops.FWD_KERNEL: (
            lambda: fwd(*inputs),
            lambda: projection_ops._project_fwd_plain(*inputs),
            bound(projection_bytes(n), PROJ_FWD_OPS * n)),
        f"{projection_ops.FWD_KERNEL}[radius]": (
            lambda: fwd(*inputs, radius_only=True),
            lambda: projection_ops._project_fwd_plain(*inputs,
                                                      radius_only=True),
            bound(projection_bytes(n, "radius"), PROJ_FWD_OPS * n)),
        projection_ops.BWD_KERNEL: (
            lambda: bwd(cots, *inputs),
            lambda: projection_ops._project_bwd_plain(cots, *inputs),
            bound(projection_bytes(n, cots), PROJ_BWD_OPS * n)),
    }
    numbers = {}
    for name, (kernel, plain, bnd) in runs.items():
        out, ref = kernel(), plain()
        err = max(float((x - y).abs().nan_to_num(0.0).max())
                  for x, y in zip(out if isinstance(out, tuple) else (out,),
                                  ref if isinstance(ref, tuple) else (ref,)))
        ms = cuda_time_ms(kernel, PROJ_ITERS)
        plain_ms = cuda_time_ms(plain, PROJ_PLAIN_ITERS)
        numbers[name] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound": bnd, "library_ms": None}
        print(f"23b. {name} on {what} ({n} gaussians): max |kernel - "
              f"plain| {err:.3e}, kernel {ms:.5f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
    return numbers


def projection_phase(dev, card: str, seed: int, params, state, cfg, cams,
                     model_dir: str):
    """Phase 23a-b: the projection's kernels against their plain versions
    on the card, bit for bit, on frame 0 of the quick-start model (and the
    prefilter's anchors), a training step's view 0 with the step's
    cotangents, phase 16's iteration-45 state (and its anchors) and the
    crafted cases; each kernel timed on that state and on frame 0 beside
    its bound and its plain version (no one PyTorch call computes it).
    Returns each kernel's numbers (phase 16's state first, every timed
    case in `modes`)."""
    t_phase = time.perf_counter()
    frame0, anchors0 = rendered_projection(params, state.active,
                                           state.contractor, cams[0], cfg, 2)
    trainer = Trainer(params, state, cfg, seed, dev)
    step_cots, step_inputs = projection_inputs(trainer.step)["backward"]
    del trainer
    tree, meta = load_train_state(model_dir, TRAIN_CKPT, device=dev)
    contractor = Contractor(
        xyz_min=torch.tensor(meta["contractor_min"], device=dev),
        xyz_max=torch.tensor(meta["contractor_max"], device=dev),
        enabled=bool(meta["contractor_enabled"]))
    cam16 = orbit_camera(0, DISK_VIEWS, width=WIDTH, height_px=HEIGHT,
                         device=dev)
    state16, anchors16 = rendered_projection(
        tree["params"], tree["active"].bool(), contractor, cam16,
        load_run_config(model_dir)[0], 0)
    del tree

    def cots_sets(inputs, first):
        n = inputs[0].shape[0]
        zeros = torch.zeros(n, device=dev)
        return {**first, "zero": (zeros,) * 6, "none": (None,) * 6,
                "culled": culled_cotangents(
                    seeded_cotangents(n, seed + 1, dev), inputs)}

    n16 = state16[0].shape[0]
    cases = [
        (f"phase 16's iteration-{TRAIN_CKPT} state", state16,
         cots_sets(state16, {"seeded": seeded_cotangents(n16, seed, dev)}),
         True),
        ("frame 0 (v2 and v3 decode the same)", frame0,
         cots_sets(frame0, {"seeded": seeded_cotangents(
             frame0[0].shape[0], seed, dev)}), True),
        ("a training step's view (its first backward)", step_inputs,
         cots_sets(step_inputs, {"the step's": step_cots}), True),
        ("the quick-start model's anchors (prefilter)", anchors0,
         cots_sets(anchors0, {"seeded": seeded_cotangents(
             anchors0[0].shape[0], seed, dev)}), False),
        (f"phase 16's iteration-{TRAIN_CKPT} anchors (prefilter)", anchors16,
         cots_sets(anchors16, {"seeded": seeded_cotangents(
             anchors16[0].shape[0], seed, dev)}), False),
    ]
    for what, arrays in projection_crafted_cases():
        inputs = (*(torch.from_numpy(a).to(dev) for a in arrays[:5]),
                  *arrays[5:])
        n = arrays[0].shape[0]
        cases.append((what, inputs, cots_sets(inputs, {
            "seeded": seeded_cotangents(n, seed, dev),
            "all six": tuple(torch.randn(n, generator=torch.Generator(
                device=dev).manual_seed(seed + k), device=dev)
                for k in range(6))}), False))
    for what, inputs in projection_ragged_cases(dev, seed):
        n = inputs[0].shape[0]
        cases.append((what, inputs, cots_sets(inputs, {
            "seeded": seeded_cotangents(n, seed, dev)}), False))
    modes = {}
    for what, inputs, cots, timed in cases:
        for name, rec in projection_case(what, inputs, cots, timed).items():
            modes.setdefault(name, {})[what] = rec
    # the prefilter's radius-only launch at its own sizes
    for what, inputs in (("the quick-start model's anchors", anchors0),
                         (f"phase 16's iteration-{TRAIN_CKPT} anchors",
                          anchors16)):
        n = inputs[0].shape[0]
        bnd = bound(projection_bytes(n, "radius"), PROJ_FWD_OPS * n)
        ms = cuda_time_ms(lambda: projection_ops.project_fwd(
            *inputs, radius_only=True), PROJ_ITERS)
        plain_ms = cuda_time_ms(lambda: projection_ops._project_fwd_plain(
            *inputs, radius_only=True), PROJ_PLAIN_ITERS)
        modes[f"{projection_ops.FWD_KERNEL}[radius]"][what] = {
            "err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "library_ms": None}
        print(f"23b. {projection_ops.FWD_KERNEL}[radius] on {what} ({n} "
              f"anchors, the prefilter's): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
    numbers = {}
    for name in PROJECTION:
        first = modes[name][cases[0][0]]
        numbers[name] = {**first, "modes": {
            what: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound"][0], "max_abs_err": r["err"]}
            for what, r in modes[name].items()}}
    numbers[projection_ops.FWD_KERNEL]["modes"].update({
        f"radius only, {what}": {"ms": r["ms"], "plain_ms": r["plain_ms"],
                                 "bound_ms": r["bound"][0],
                                 "max_abs_err": r["err"]}
        for what, r in modes[f"{projection_ops.FWD_KERNEL}[radius]"].items()})
    print(f"  phase 23a-b wall {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    return numbers


def projection_launch_table(phase_launches: dict, training):
    """23c: the projection's kernels' launches on each phase's main path
    (each phase's own `check_projection` held them); every phase
    projected through the kernel, and every phase in `training` took its
    backward through the other."""
    table = {phase: {k: launches.get(k, 0) for k in PROJECTION}
             for phase, launches in phase_launches.items()}
    print(f"23c. the projection's kernels' launches on each phase's main "
          f"path: {json.dumps(table)}")
    for phase, got in table.items():
        if not got[projection_ops.FWD_KERNEL] or (
                phase in training and not got[projection_ops.BWD_KERNEL]):
            raise AssertionError(f"{phase} did not project through the "
                                 "kernels")


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
    if name in XLA_STAGES:
        out["replaces_kind"] = "XLA stage (no Pallas kernel)"
    for key in ("launch_floor_ms", "turns_ms", "bound_terms_ms", "modes",
                "kernel_scale"):
        if key in numbers:
            out[key] = numbers[key]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sharded-rank", metavar="DIR",
                    help="run as one rank of phase 18's mesh (set by the "
                    "phase itself)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    if args.sharded_rank:
        return sharded_rank(args.sharded_rank)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

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
    # 24. the same orbit eager and through the decode's CUDA graph
    decode_graph_phase(params, state, cfg, cams, level)

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
        eval_pair = eval_image_pair(model_dir)  # for phase 22
        # 19. the viewer, the profiling switches and the hard protocol
        last_launches = last_paths_phase(args, dev, smi, tmp, scene_dir,
                                         model_dir, params, state, cfg)
        # 20. the tri-plane sampler's kernels at full width, and phase 16's
        # trained state with and without its padding rows
        sampler_numbers = sampler_phase(dev, smi, args.seed, model_dir)
        # 21. the binning kernels and the slot reduce on the main paths'
        # inputs, phase 16's trained state and a hot tile
        binning_numbers = binning_phase(dev, smi, args.seed, params, state,
                                        cfg, cams, model_dir)
        # 23. the projection's kernels on the main paths' inputs, a
        # step's cotangents, phase 16's trained state and crafted rows
        projection_numbers = projection_phase(dev, smi, args.seed, params,
                                              state, cfg, cams, model_dir)

    # 18. the sharded step: a 1x1 mesh over NCCL, four ranks on the card
    sharded_launches = sharded_phase(params, state, cfg, args, dev, smi)

    # 22. SSIM's kernels against their plain versions, timed
    ssim_numbers = ssim_phase(dev, smi, args.seed, eval_pair)

    phases = (fwd["launches"], train_launches, fwd3["launches"],
              train3_launches, disk_launches, train_disk_launches,
              eval_launches, last_launches, sharded_launches)
    phase_launches = dict(zip(
        ("4 render_set v2", "7 training v2", "12 render_set v3",
         "13 training v3", "15 render_sets and render_torch.py",
         "16 train_torch.py", "17 evaluation",
         "19 viewer, --profile, attribution, hard protocol",
         "18 sharded steps"), phases))
    binning_launch_table(phase_launches)
    ssim_launch_table(phase_launches, (
        "7 training v2", "13 training v3", "16 train_torch.py",
        "17 evaluation", "19 viewer, --profile, attribution, hard protocol",
        "18 sharded steps"))
    projection_launch_table(phase_launches, (
        "7 training v2", "13 training v3", "16 train_torch.py",
        "19 viewer, --profile, attribution, hard protocol",
        "18 sharded steps"))
    print(json.dumps({"kernels": [
        entry(KERNEL, fwd["launches"].get(KERNEL, 0)
              + train_launches.get(KERNEL, 0)
              + disk_launches.get(KERNEL, 0)
              + train_disk_launches.get(KERNEL, 0)
              + eval_launches.get(KERNEL, 0)
              + sharded_launches.get(KERNEL, 0)
              + last_launches.get(KERNEL, 0), fwd),
        entry(BWD_KERNEL, train_launches.get(BWD_KERNEL, 0)
              + train_disk_launches.get(BWD_KERNEL, 0)
              + sharded_launches.get(BWD_KERNEL, 0)
              + last_launches.get(BWD_KERNEL, 0), bwd),
        entry(KERNEL16, fwd3["launches"].get(KERNEL16, 0)
              + train3_launches.get(KERNEL16, 0)
              + disk_launches.get(KERNEL16, 0)
              + train_disk_launches.get(KERNEL16, 0)
              + eval_launches.get(KERNEL16, 0)
              + sharded_launches.get(KERNEL16, 0)
              + last_launches.get(KERNEL16, 0), fwd3),
        entry(BWD_KERNEL16, train3_launches.get(BWD_KERNEL16, 0)
              + train_disk_launches.get(BWD_KERNEL16, 0)
              + sharded_launches.get(BWD_KERNEL16, 0)
              + last_launches.get(BWD_KERNEL16, 0), bwd3),
        *(entry(name, probe_launches[name], nums)
          for name, nums in probe_numbers.items()),
        *(entry(name, sum(p.get(name, 0) for p in phases),
                sampler_numbers[name]) for name in SAMPLER),
        *(entry(name, sum(p.get(name, 0) for p in phases),
                binning_numbers[name]) for name in BINNING),
        *(entry(name, sum(p.get(name, 0) for p in phases),
                ssim_numbers[name]) for name in SSIM),
        *(entry(name, sum(p.get(name, 0) for p in phases),
                projection_numbers[name]) for name in PROJECTION),
    ]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
