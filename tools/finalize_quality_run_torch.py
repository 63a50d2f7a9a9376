#!/usr/bin/env python
"""Finalize a quality run of the PyTorch/CUDA port from its newest
training checkpoint (counterpart of tools/finalize_quality_run.py).

tools/quality_run_torch.py writes its payload only when training ends,
and a training checkpoint at every eval iteration.  When a run is cut
short, this tool restores the newest checkpoint through
`Trainer.restore` and writes the same payload -- the final test metrics,
the offline artifacts and the trajectory parsed from the run's log --
marked with `finalized_from_checkpoint`.

    python3 tools/finalize_quality_run_torch.py --scene quality_scene \\
        --model quality_out --out RESULTS_torch.json [--device cpu]

--iterations is the run's planned length (its cadence); --log defaults to
the model's outputs.log.  Runs on the card unless --device cpu is
given."""
import argparse
import json
import os
import re
import sys

import numpy as np

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)

import quality_run_torch as qr  # noqa: E402
from splatco_torch.data.scene import Scene  # noqa: E402
from splatco_torch.train.loop import Trainer  # noqa: E402
from splatco_torch.utils.device import resolve_device  # noqa: E402

PAT_ITER = re.compile(
    r"\[ITER (\d+)\] loss ([\d.]+) anchors (\d+) step_ms (\d+)")
PAT_EVAL = re.compile(
    r"\[ITER (\d+)\] eval (test|train): L1 ([\d.]+) PSNR ([\d.]+) "
    r"SSIM ([\d.]+)")
PAT_DENSIFY = re.compile(
    r"\[ITER (\d+)\] densify: \+(\d+) -(\d+) \(cvpm marked (\d+), "
    r"dropped (\d+)\) -> (\d+) anchors")
PAT_GROW = re.compile(r"growing anchor capacity -> (\d+)")


def parse_trajectory(log_path: str):
    """The trainer's log lines -> (progress records, events): the fields
    Trainer.metrics_log carries in a finished run's payload."""
    traj, events = [], []
    with open(log_path, errors="replace") as fh:
        for line in fh:
            m = PAT_ITER.search(line)
            if m:
                traj.append({"iteration": int(m.group(1)),
                             "loss": float(m.group(2)),
                             "anchors": int(m.group(3)),
                             "step_ms": int(m.group(4))})
            m = PAT_EVAL.search(line)
            if m:
                events.append({"iteration": int(m.group(1)),
                               "split": m.group(2),
                               "l1": float(m.group(3)),
                               "psnr": float(m.group(4)),
                               "ssim": float(m.group(5))})
            m = PAT_DENSIFY.search(line)
            if m:
                events.append({"iteration": int(m.group(1)),
                               "densify_grown": int(m.group(2)),
                               "densify_pruned": int(m.group(3)),
                               "cvpm_marked": int(m.group(4)),
                               "densify_dropped": int(m.group(5)),
                               "anchors_after": int(m.group(6))})
            m = PAT_GROW.search(line)
            if m:
                events.append({"capacity_regrow": int(m.group(1))})
    return traj, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--log", default=None,
                    help="the run's log (default <model>/outputs.log)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--iterations", type=int, default=15000,
                    help="the run's planned length (cadence scaling)")
    ap.add_argument("--views", type=int, default=28)
    ap.add_argument("--points", type=int, default=3500)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--skip_artifacts", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    log_path = args.log or os.path.join(args.model, "outputs.log")
    # read before the trainer's logger reopens the model's log
    traj, events = parse_trajectory(log_path)
    cfg, opt, pipe, kwargs = qr.protocol(args.scene, args.model,
                                         args.iterations)
    scene = Scene(cfg, shuffle=False, device=dev)
    tr = Trainer(cfg, opt, pipe, device=dev, **kwargs)
    tr.setup(scene, seed=0)
    restored = tr.restore()
    print(f"restored checkpoint at iteration {restored}")

    finals = qr.final_test(tr, scene)
    artifacts = (None if args.skip_artifacts
                 else qr.offline_artifacts(cfg, tr, args))
    payload = {
        "config": {
            "iterations": args.iterations,
            "backend": "cuda" if dev.type == "cuda" else "plain",
            "mv": pipe.mv, "views": args.views, "points": args.points,
            "resolution": [args.height, args.width],
            "activation_iterations": list(kwargs["activation_iterations"]),
            "densify_window": [opt.update_from, opt.update_until],
            "graph_downsampling_iters": [],
            "hard_protocol": True,
        },
        "finalized_from_checkpoint": restored,
        "offline_artifacts": artifacts,
        "final_test": {k: float(np.mean(v)) for k, v in finals.items()},
        "final_test_per_view": finals,
        "anchors_final": int(tr.mstate.active.sum()),
        "kmax_pack_final": None,
        "class_spec_final": None,
        "trajectory": traj,
        "events": events,
    }
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(json.dumps({"final_test": payload["final_test"],
                      "anchors": payload["anchors_final"],
                      "restored_iteration": restored}))
    return payload


if __name__ == "__main__":
    main()
