#!/usr/bin/env python3
"""Drive the splatco_torch render path on one NVIDIA card and hold its CUDA
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N] [--frames N]

Run from the repository root.  Phases, each of which fails loudly:
  1. the card's name and power limit (nvidia-smi),
  2. build every kernel under splatco_torch/csrc with nvcc for sm_90a,
  3. kernel check: a random projected scene (~200k gaussians, 1600x1088)
     through the port's binning, then the CUDA blend kernel against its
     plain version on the card,
  4. main path at full width: the README quick-start model (feat_dim 32,
     n_offsets 10, num_channels 15, plane_size 2800 -> plane levels
     [700, 700, 1400] with TPA on level 0, contractor, bbox_scale 0.3)
     with 65,536 anchors from a seeded normal cloud (655,360 gaussians),
     rendered at activate_level 2 from orbit cameras at 1600x1088 through
     `render_set`; the kernel's launch count must equal the frames,
  5. one frame's stages timed, and the kernel timed against its plain
     version at that frame's shapes, with its bound,
  6. a small model rendered on the card and on the CPU must agree.
Prints a `kernels` JSON line, then, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero and prints no result when
there is no CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from splatco_torch.config import ModelConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.eval.render_driver import render_set
from splatco_torch.models.renderer import (generate_neural_gaussians,
                                           prefilter_voxel, render)
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops import cuda_lib
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols, project_gaussians_cols
from splatco_torch.ops.rasterize import tile_grid
from splatco_torch.ops.rasterize_cuda import (KERNEL, raster_fwd,
                                              raster_fwd_plain)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, fp32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32/SFU operations per pixel evaluation of a record (dx, dy, power,
# compare, exp, alpha, clamp, compare) and per contribution (1 - alpha,
# T (1 - alpha), compare, w, three colour multiply-adds)
OPS_PER_EVAL = 16
OPS_PER_CONTRIB = 10
# kernel vs plain version on the same inputs: the same float32 operations
# in the same order (the kernel is built with --fmad=false), so they agree
# up to the library exp; held to the bound the CPU tests use against JAX
RASTER_TOL = 1e-5
WIDTH, HEIGHT = 1600, 1088


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back runs, after one
    warm-up run (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


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


def compare_kernel(binned, tiles_x, tiles_y, work=None):
    """Max |kernel - plain| of rgb and of T on the same binned records."""
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, HEIGHT, WIDTH)
    rgb, t_fin = raster_fwd(*args)
    p_rgb, p_t = raster_fwd_plain(*args, work=work)
    torch.cuda.synchronize()
    return (float((rgb - p_rgb).abs().max()),
            float((t_fin - p_t).abs().max()))


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


def frame_stages(params, state, cam, cfg, level):
    """One frame's stages as render() runs them, each timed with CUDA
    events (and named for torch.profiler); returns (binned records,
    {stage: ms})."""
    tiles_x, tiles_y = tile_grid(cam.image_height, cam.image_width)
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
        binned = bin_gaussians(proj, g["color"], g["opacity"], TILE,
                               tiles_x, tiles_y, kmax=cfg.kmax)
    with stage("blend"):
        raster_fwd(binned.records, binned.tile_start, binned.tile_end,
                   tiles_x, tiles_y, cam.image_height, cam.image_width)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
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

    # 3. kernel check on a random projected scene
    proj, colors, opac = random_projected_scene(200_000, args.seed, dev)
    tiles_x, tiles_y = tile_grid(HEIGHT, WIDTH)
    binned = bin_gaussians(proj, colors, opac, TILE, tiles_x, tiles_y)
    err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y)
    print(f"random scene: {binned.records.shape[1]} pairs, clipped "
          f"{int(binned.num_clipped)}; kernel vs plain max |d| rgb "
          f"{err_rgb:.3e} T {err_t:.3e} (tolerance {RASTER_TOL})")
    if not max(err_rgb, err_t) <= RASTER_TOL:
        raise AssertionError("raster_fwd disagrees with its plain version")

    # 4. main path at full width
    cfg = quickstart_config()
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
    with tempfile.TemporaryDirectory() as out_dir:
        cuda_lib.LAUNCHES.clear()
        fps = render_set(out_dir, "orbit", 0, cams, params, state.active,
                         state.contractor, level, cfg)
        launches = dict(cuda_lib.LAUNCHES)
    print(f"render_set: {args.frames} frames at {WIDTH}x{HEIGHT}, "
          f"{1e3 / fps:.3f} ms/frame (CUDA events, after a warm-up frame)"
          f"; launches {launches}")
    if launches.get(KERNEL, 0) != args.frames:
        raise AssertionError(f"{KERNEL} launched {launches.get(KERNEL, 0)}"
                             f" times for {args.frames} frames")

    with torch.inference_mode():
        vis = prefilter_voxel(params["anchors"], state.active, cams[0])
        out = render(params, state.active, state.contractor, cams[0],
                     torch.zeros(3, device=dev), visible_mask=vis,
                     activate_level=level, **decode_kwargs(cfg))
        img = out.image
        if img.shape != (3, HEIGHT, WIDTH) or not bool(
                torch.isfinite(img).all()) or not float(img.std()) > 0:
            raise AssertionError("main-path image is not finite and varied")
        print(f"frame 0: {out.num_pairs} pairs, num_clipped "
              f"{int(out.num_clipped)}, selected "
              f"{int(out.selection_mask.sum())} gaussians, image mean "
              f"{float(img.mean()):.4f} std {float(img.std()):.4f}")

        # 5. stages and the kernel at the main path's shapes
        frame_stages(params, state, cams[0], cfg, level)  # warm-up
        binned, stages = frame_stages(params, state, cams[0], cfg, level)
        print(f"frame 0 stages ms (CUDA events): {json.dumps(stages)}")
        work = {}
        err_rgb, err_t = compare_kernel(binned, tiles_x, tiles_y, work)
        err = max(err_rgb, err_t)
        print(f"main path: kernel vs plain max |d| rgb {err_rgb:.3e} T "
              f"{err_t:.3e}")
        if not err <= RASTER_TOL:
            raise AssertionError("raster_fwd disagrees with its plain "
                                 "version at the main path's shapes")
        rargs = (binned.records, binned.tile_start, binned.tile_end,
                 tiles_x, tiles_y, HEIGHT, WIDTH)
        kernel_ms = cuda_time_ms(lambda: raster_fwd(*rargs), 20)
        plain_ms = cuda_time_ms(lambda: raster_fwd_plain(*rargs), 2)

    pairs = binned.records.shape[1]
    n_bytes = (9 * 4 * pairs + 2 * 4 * tiles_x * tiles_y
               + 4 * 4 * tiles_x * tiles_y * TILE * TILE)
    evals, contribs = int(work["evals"]), int(work["contribs"])
    n_ops = OPS_PER_EVAL * evals + OPS_PER_CONTRIB * contribs
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_FP32_PER_S
    print(f"blend work: {pairs} pairs, {evals} pixel evaluations, "
          f"{contribs} contributions, {n_bytes} bytes; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")

    small_model_agrees(args.seed, dev)

    print(json.dumps({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "splatco_torch/csrc/raster_fwd.cu",
        "replaces": "splatco_tpu/ops/rasterize_pallas.py:182",
        "launches": launches.get(KERNEL, 0),
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
