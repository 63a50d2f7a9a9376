"""Quality metrics driver (counterpart of splatco_tpu/eval/metrics_driver.py,
the reference's metrics.py).

PSNR / SSIM / LPIPS (VGG) / FLIP of every render against its ground truth
under <model>/test/<method>/{renders,gt}, written to results.json and
per_view.json with the JAX driver's keys and layout.  LPIPS needs local
weights (ops/lpips.py); without them it is recorded as null.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from splatco_torch.data.images import read_image
from splatco_torch.ops import lpips as lpips_lib
from splatco_torch.ops.flip import ldr_flip
from splatco_torch.ops.losses import psnr, ssim
from splatco_torch.utils.device import resolve_device


def read_images(renders_dir: str, gt_dir: str):
    """Each render and its ground truth as [3,H,W] float32 numpy arrays
    in [0,1] (the first three channels), in file-name order."""
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = np.float32(read_image(os.path.join(renders_dir, fname))) / 255.0
        g = np.float32(read_image(os.path.join(gt_dir, fname))) / 255.0
        renders.append(r.transpose(2, 0, 1)[:3])
        gts.append(g.transpose(2, 0, 1)[:3])
        names.append(fname)
    return renders, gts, names


def view_metrics(render: torch.Tensor, gt: torch.Tensor,
                 weights: Optional[Dict[str, torch.Tensor]]) -> Dict:
    """One view's SSIM, PSNR, FLIP and (with weights) LPIPS as floats."""
    out = {"SSIM": float(ssim(render, gt)),
           "PSNR": float(psnr(render, gt).mean()),
           "FLIP": float(ldr_flip(render, gt))}
    if weights is not None:
        out["LPIPS"] = float(lpips_lib.lpips(weights, render, gt))
    return out


def evaluate_dir(test_dir: str, lpips_weights: Optional[str] = None,
                 device=None) -> Dict:
    """Evaluate every method (ours_N) under a scene's test/ directory on
    `device` (None: the card)."""
    dev = resolve_device(device)
    full, per_view = {}, {}
    weights = lpips_lib.load_weights(lpips_weights, device=dev)
    for method in sorted(os.listdir(test_dir)):
        mdir = os.path.join(test_dir, method)
        if not os.path.isdir(mdir):
            continue
        renders, gts, names = read_images(os.path.join(mdir, "renders"),
                                          os.path.join(mdir, "gt"))
        views = []
        with torch.inference_mode():
            for r, g in zip(renders, gts):
                views.append(view_metrics(torch.as_tensor(r, device=dev),
                                          torch.as_tensor(g, device=dev),
                                          weights))

        def column(key):
            return [v[key] for v in views]

        lpipss = column("LPIPS") if weights is not None else []
        full[method] = {
            "SSIM": float(np.mean(column("SSIM"))),
            "PSNR": float(np.mean(column("PSNR"))),
            "LPIPS": float(np.mean(lpipss)) if lpipss else None,
            "FLIP": float(np.mean(column("FLIP"))),
        }
        per_view[method] = {
            "SSIM": dict(zip(names, column("SSIM"))),
            "PSNR": dict(zip(names, column("PSNR"))),
            "LPIPS": dict(zip(names, lpipss)) if lpipss else None,
            "FLIP": dict(zip(names, column("FLIP"))),
        }
        print(f"  {method}: PSNR {full[method]['PSNR']:.4f} "
              f"SSIM {full[method]['SSIM']:.4f} "
              f"FLIP {full[method]['FLIP']:.4f} "
              f"LPIPS {full[method]['LPIPS']}")
    return {"full": full, "per_view": per_view}


def evaluate(model_paths: List[str], lpips_weights: Optional[str] = None,
             device=None) -> Dict:
    """Evaluate each model directory's test renders on `device` (None:
    the card) and write its results.json and per_view.json."""
    dev = resolve_device(device)
    out = {}
    for scene_dir in model_paths:
        print(f"Scene: {scene_dir}")
        res = evaluate_dir(os.path.join(scene_dir, "test"), lpips_weights,
                           device=dev)
        ng_path = os.path.join(scene_dir, "num_gaussians.json")
        if os.path.exists(ng_path):
            with open(ng_path) as fh:
                res["num_gaussians"] = json.load(fh)
        with open(os.path.join(scene_dir, "results.json"), "w") as fh:
            json.dump(res["full"], fh, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as fh:
            json.dump(res["per_view"], fh, indent=2)
        out[scene_dir] = res
    return out
