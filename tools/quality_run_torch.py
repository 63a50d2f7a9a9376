#!/usr/bin/env python
"""Quality run of the PyTorch/CUDA port (counterpart of
tools/quality_run.py, whose protocol and RESULTS payload it keeps):
a multi-thousand-iteration training run with the production
configuration (densification, CVPM, plane-level activation) on a
synthetic Blender scene, the PSNR/SSIM trajectory and the final test
metrics, then the offline artifacts of the trained model: render_sets
(per-view PNGs, FPS, num_gaussians.json), the metrics driver
(results.json, per_view.json) and the popping harness over a 48-frame
orbit stream (popping_results.json, its plots).

    python3 tools/quality_run_torch.py --iterations 15000 \
        --out RESULTS_torch.json [--device cpu]

Runs on the card unless --device cpu is given.  A failing artifact stage
fails the run.  The hard synthetic protocol (--hard, --arc_period) is not
ported."""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from splatco_torch.config import (ModelConfig,  # noqa: E402
                                  OptimizationConfig, PipelineConfig)
from splatco_torch.data.images import save_png  # noqa: E402
from splatco_torch.data.scene import Scene  # noqa: E402
from splatco_torch.eval.metrics_driver import evaluate  # noqa: E402
from splatco_torch.eval.popping import validate_popping  # noqa: E402
from splatco_torch.eval.render_driver import render_sets  # noqa: E402
from splatco_torch.models.renderer import prefilter_voxel  # noqa: E402
from splatco_torch.models.renderer import render  # noqa: E402
from splatco_torch.models.splatco import decode_kwargs  # noqa: E402
from splatco_torch.ops.flip import ldr_flip  # noqa: E402
from splatco_torch.ops.losses import psnr, ssim  # noqa: E402
from splatco_torch.train.loop import Trainer  # noqa: E402
from splatco_torch.utils.device import resolve_device  # noqa: E402
from splatco_torch.utils.synthetic import (  # noqa: E402
    orbit_camera, write_blender_dataset)

ORBIT_FRAMES = 48


def offline_artifacts(cfg, tr, args):
    """The offline evaluation pipeline against the trained model: the
    render driver, the metrics driver, and the popping harness over a
    smooth orbit stream (Farneback flow)."""
    out = {}
    fps, n_anchors = render_sets(cfg, iteration=-1, device=tr.dev)
    out["fps"] = fps
    out["num_gaussians"] = n_anchors
    out["metrics"] = evaluate([cfg.model_path], device=tr.dev)

    # orbit render stream for the temporal-consistency harness
    orbit_dir = os.path.join(cfg.model_path, "orbit", "renders")
    os.makedirs(orbit_dir, exist_ok=True)
    bg = tr._bg()
    dkw = decode_kwargs(cfg)
    with torch.inference_mode():
        for i in range(ORBIT_FRAMES):
            cam = orbit_camera(i, ORBIT_FRAMES, radius=3.2, height=0.6,
                               width=args.width, height_px=args.height,
                               device=tr.dev)
            vis = prefilter_voxel(tr.params["anchors"], tr.mstate.active,
                                  cam)
            img = render(tr.params, tr.mstate.active, tr.mstate.contractor,
                         cam, bg, visible_mask=vis,
                         activate_level=tr.activate_level,
                         is_training=False, kmax=cfg.kmax, **dkw).image
            save_png(os.path.join(orbit_dir, f"{i:05d}.png"),
                     img.clamp(0, 1).cpu().numpy())
    pop = validate_popping(
        orbit_dir, steps=(1, 7),
        out_json=os.path.join(cfg.model_path, "popping_results.json"),
        plot_dir=os.path.join(cfg.model_path, "orbit", "plots"),
        device=tr.dev)
    out["popping"] = {k: v["aggregate"] for k, v in pop.items()}
    # the reference's popping numbers use RAFT flow, whose weights are not
    # in the repository: these use OpenCV's Farneback estimator, comparable
    # within a stream, not directly against the reference's numbers
    out["popping_flow"] = "farneback (no RAFT weights in the repository; "\
        "detect_popping_torch.py --flow raft loads the official .pth when "\
        "given)"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=15000)
    ap.add_argument("--scene", default="quality_scene")
    ap.add_argument("--model", default="quality_out")
    ap.add_argument("--out", default="RESULTS_torch.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--views", type=int, default=28)
    ap.add_argument("--points", type=int, default=1200)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--max_capacity", type=int, default=0,
                    help="cap densify capacity regrowth")
    ap.add_argument("--downsample", action="store_true",
                    help="re-enable graph downsampling (the reference's "
                    "quick-start passes --no_downsample)")
    ap.add_argument("--skip_artifacts", action="store_true",
                    help="skip the post-training offline artifact stage "
                    "(render FPS / results.json / popping)")
    ap.add_argument("--no_multilevel", action="store_true",
                    help="ablation: disable CSCM plane-level activation")
    ap.add_argument("--no_consistency", action="store_true",
                    help="ablation: disable the SVC multi-view "
                    "consistency loss")
    ap.add_argument("--no_cvpm", action="store_true",
                    help="ablation: disable CVPM cross-view pruning")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.scene,
                                       "transforms_train.json")):
        print(f"writing synthetic scene -> {args.scene}")
        write_blender_dataset(args.scene, n_views=args.views,
                              n_pts=args.points, width=args.width,
                              height=args.height, device=dev)

    it_total = args.iterations
    cfg = ModelConfig(source_path=args.scene, model_path=args.model,
                      feat_dim=32, n_offsets=10, voxel_size=0.01,
                      plane_size=512, num_channels=9, appearance_dim=0,
                      contractor=True, white_background=True, eval=True,
                      max_capacity=args.max_capacity)
    opt = OptimizationConfig(iterations=it_total)
    # the reference's quick-start passes --no_downsample
    if not args.downsample:
        opt.graph_downsampling_iters = []
    # scale the reference cadence to the run length so every phase
    # (stat warm-up, densify window, activation, polish) is exercised
    scale = it_total / 30000.0
    opt.start_stat = max(int(500 * scale), 10)
    opt.update_from = max(int(1500 * scale), 20)
    opt.update_until = max(int(15000 * scale), 200)
    opt.position_lr_max_steps = it_total
    opt.offset_lr_max_steps = it_total
    opt.mlp_opacity_lr_max_steps = it_total
    opt.mlp_cov_lr_max_steps = it_total
    opt.mlp_color_lr_max_steps = it_total
    act1 = max(int(12000 * scale), 100)
    act2 = max(int(21000 * scale), 200)
    tests = sorted({max(int(f * scale), 1) for f in
                    (3000, 7000, 12000, 17000, 22000, 30000)} | {it_total})
    pipe = PipelineConfig(mv=4)

    scene = Scene(cfg, shuffle=False, device=dev)
    tr = Trainer(cfg, opt, pipe, test_iterations=tuple(tests),
                 save_iterations=(it_total,),
                 checkpoint_iterations=tuple(tests),  # resumable at evals
                 activation_iterations=(act1, act2),
                 no_multilevel=args.no_multilevel,
                 no_consistency=args.no_consistency,
                 no_cvpm=args.no_cvpm, device=dev)
    tr.setup(scene, seed=0)
    t0 = time.time()
    tr.train(iterations=it_total, progress_every=max(it_total // 60, 10))
    wall = time.time() - t0

    # ---- final offline metrics over the test split ----------------------
    bg = tr._bg()
    dkw = decode_kwargs(cfg)
    finals = {"psnr": [], "ssim": [], "flip": []}
    with torch.inference_mode():
        for cam in scene.test_cameras():
            vis = prefilter_voxel(tr.params["anchors"], tr.mstate.active,
                                  cam)
            out = render(tr.params, tr.mstate.active, tr.mstate.contractor,
                         cam, bg, visible_mask=vis,
                         activate_level=tr.activate_level,
                         is_training=False, kmax=cfg.kmax, **dkw)
            img = torch.clamp(out.image, 0, 1)
            gt = torch.clamp(cam.image, 0, 1)
            finals["psnr"].append(float(psnr(img, gt).mean()))
            finals["ssim"].append(float(ssim(img, gt)))
            finals["flip"].append(float(ldr_flip(img, gt)))

    # ---- offline artifacts: render / metrics / popping against the
    # trained model ---------------------------------------------------------
    artifacts = (None if args.skip_artifacts
                 else offline_artifacts(cfg, tr, args))

    payload = {
        "config": {
            "iterations": it_total,
            "backend": "cuda" if dev.type == "cuda" else "plain",
            "mv": pipe.mv, "views": args.views, "points": args.points,
            "resolution": [args.height, args.width],
            "activation_iterations": [act1, act2],
            "densify_window": [opt.update_from, opt.update_until],
            "graph_downsampling_iters": list(
                opt.graph_downsampling_iters),
            "ablation": {"no_multilevel": args.no_multilevel,
                         "no_consistency": args.no_consistency,
                         "no_cvpm": args.no_cvpm},
        },
        "offline_artifacts": artifacts,
        "wall_seconds": round(wall, 1),
        "final_test": {k: float(np.mean(v)) for k, v in finals.items()},
        "final_test_per_view": finals,
        "anchors_final": int(tr.mstate.active.sum()),
        # the port has no static slot budgets
        "kmax_pack_final": None,
        "class_spec_final": None,
        "trajectory": tr.metrics_log,
    }
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(json.dumps({"final_test": payload["final_test"],
                      "anchors": payload["anchors_final"],
                      "wall_s": payload["wall_seconds"]}))
    return payload


if __name__ == "__main__":
    main()
