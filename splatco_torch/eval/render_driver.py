"""Offline render driver (counterpart of splatco_tpu/eval/render_driver.py):
load a trained model (the JAX trainer's checkpoints or a reference-trained
model), render a scene's train and test views, write per-view PNGs and
num_gaussians.json, and measure frames per second.

The card is timed with CUDA events: the first frame is a warm-up, the
rest are timed back to back.  The class-budget passes of the JAX driver
have no counterpart: the port's binning has no static budget.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import torch

from splatco_torch.config import ModelConfig
from splatco_torch.data.cameras import Camera
from splatco_torch.data.images import save_png
from splatco_torch.data.scene import Scene
from splatco_torch.models.contraction import Contractor, make_contractor
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.train import checkpoint as ckpt
from splatco_torch.train.import_reference import load_reference_model
from splatco_torch.utils.device import resolve_device


def load_trained(cfg: ModelConfig, iteration: int = -1, device=None,
                 scene: Optional[Scene] = None):
    """-> (params, active, contractor, activate_level, iteration) on
    `device` (None: the card).  A model trained by the reference pipeline
    (point_cloud/iteration_N/checkpoints.pth) is imported
    (train/import_reference.py), any other is read as the JAX trainer's
    checkpoint.  The contractor's bounds come from the checkpoint (meta.json
    or the reference's chkpnt file), else from the config's scene box;
    eval activates every plane level unless the meta says otherwise.
    `scene` is the JAX signature's: the port takes the model's layout from
    the config, so it reads nothing from the scene."""
    dev = resolve_device(device)
    if iteration == -1:
        iteration = ckpt.latest_iteration(cfg.model_path)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoints in {cfg.model_path}")
    ref_pth = os.path.join(cfg.model_path, "point_cloud",
                           f"iteration_{iteration}", "checkpoints.pth")
    if os.path.exists(ref_pth):
        params, active, bounds = load_reference_model(
            cfg.model_path, iteration, cfg, device=dev)
        meta = {}
        if bounds is not None:
            meta = {"contractor_min": bounds[0].tolist(),
                    "contractor_max": bounds[1].tolist()}
    else:
        params, active, meta = ckpt.load_model_checkpoint(
            cfg.model_path, iteration, device=dev)
    meta = meta or {}
    box = make_contractor(cfg.scene_center, cfg.scene_length,
                          cfg.bbox_scale, enabled=cfg.contractor, device=dev)

    def bound(key, default):
        if key not in meta:
            return default
        return torch.as_tensor(meta[key], dtype=torch.float32, device=dev)

    contractor = Contractor(xyz_min=bound("contractor_min", box.xyz_min),
                            xyz_max=bound("contractor_max", box.xyz_max),
                            enabled=cfg.contractor)
    activate_level = meta.get("activate_level", 2)
    return params, active, contractor, activate_level, iteration


def render_set(model_path: str, name: str, iteration: int,
               cameras: List[Camera], params, active: torch.Tensor,
               contractor: Contractor, activate_level: int,
               cfg: ModelConfig, tile16: Optional[bool] = None,
               backend: str = "cuda") -> float:
    """Render `cameras` into <model_path>/<name>/ours_<iteration>/renders
    (and gt/ where a camera has an image); returns frames per second,
    timed with CUDA events on the card and the host clock on the CPU.
    `tile16` picks the rasterizer configuration (ops/rasterize.py; None:
    the SPLATCO_RASTER switch); `backend="dense"` renders with the dense
    compositor instead of the tile kernels."""
    out_dir = os.path.join(model_path, name, f"ours_{iteration}")
    render_dir = os.path.join(out_dir, "renders")
    gt_dir = os.path.join(out_dir, "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    dev = active.device
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else
                      [0.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    dkw = decode_kwargs(cfg)

    def render_cam(cam):
        vis = prefilter_voxel(params["anchors"], active, cam)
        return render(params, active, contractor, cam, bg, visible_mask=vis,
                      activate_level=activate_level, kmax=cfg.kmax,
                      tile16=tile16, backend=backend, **dkw).image

    on_card = dev.type == "cuda"
    images = []
    with torch.inference_mode():
        for idx, cam in enumerate(cameras):
            images.append(render_cam(cam))
            if idx == 0:  # warm-up frame, off the clock
                if on_card:
                    t0 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                else:
                    t0 = time.perf_counter()
        timed = len(images) - 1
        if timed == 0 and images:  # one camera: time a second render
            images.append(render_cam(cameras[0]))
            timed = 1
        if not images:
            fps = 0.0
        elif on_card:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            fps = 1e3 * timed / max(t0.elapsed_time(t1), 1e-9)
        else:
            fps = timed / max(time.perf_counter() - t0, 1e-9)

    for idx, cam in enumerate(cameras):
        img = images[idx].clamp(0.0, 1.0).cpu().numpy()
        save_png(os.path.join(render_dir, f"{idx:05d}.png"), img)
        if cam.image is not None:
            save_png(os.path.join(gt_dir, f"{idx:05d}.png"),
                     cam.image.cpu().numpy())
    clock = "CUDA events" if on_card else "host clock, CPU"
    print(f"{name} FPS: {fps:.2f} ({clock})")
    return fps


def render_sets(cfg: ModelConfig, iteration: int = -1,
                skip_train: bool = False, skip_test: bool = False,
                device=None, backend: str = "cuda"):
    """Render the scene at `cfg.source_path` (train and test views, not
    shuffled) from the model at `cfg.model_path` on `device` (None: the
    card) in the rasterizer configuration SPLATCO_RASTER selects (or with
    the dense compositor, `backend="dense"`), and write
    num_gaussians.json.  Returns ({set: fps}, anchors)."""
    scene = Scene(cfg, shuffle=False, write_artifacts=False, device=device)
    params, active, contractor, lvl, it = load_trained(
        cfg, iteration, device=scene.device, scene=scene)
    n_anchors = int(active.sum())
    fps = {}
    if not skip_train:
        fps["train"] = render_set(cfg.model_path, "train", it,
                                  scene.train_cameras(), params, active,
                                  contractor, lvl, cfg, backend=backend)
    if not skip_test:
        fps["test"] = render_set(cfg.model_path, "test", it,
                                 scene.test_cameras(), params, active,
                                 contractor, lvl, cfg, backend=backend)
    with open(os.path.join(cfg.model_path, "num_gaussians.json"),
              "w") as fh:
        json.dump({os.path.basename(os.path.normpath(cfg.model_path)):
                   n_anchors, "fps": fps}, fh)
    return fps, n_anchors
