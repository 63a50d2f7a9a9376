"""Profile the splatco_torch training step on the card at chip_smoke.py's
training size: per-phase CUDA-event times, the device's busy share, and
torch.profiler's kernel table.

    PYTHONPATH=. python tools/profile_torch_train.py [--steps 3]
        [--level 0] [--v3] [--out PATH]

Prints the summary and the kernel table; with --out it also writes them
and the host-time table to PATH.  --v3 trains in the v3 configuration
(16 px tiles, kmax 32, as chip_smoke.py's phase 13).

The model is chip_smoke's quick-start-width model (655,360 gaussians);
each step renders mv = 4 views at 1600x1088 (chip_smoke.Trainer).  After
one warm-up step, `--steps` steps are timed with the host clock (wall,
ending in a synchronize) and CUDA events per phase, then `--steps` more
run under torch.profiler.  The busy share is the profiled device time of
all kernels, memcpys and memsets over the unprofiled wall time (one
stream, so kernels do not overlap).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from splatco_torch.models.splatco import init_model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--v3", action="store_true",
                    help="16 px tiles (tile16=True) with kmax 32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = cs.quickstart_config()
    if args.v3:
        cfg = dataclasses.replace(cfg, kmax=cs.KMAX_V3)
    pts = np.random.default_rng(args.seed).normal(
        size=(65536, 3)).astype(np.float32) * 1.2
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    trainer = cs.Trainer(params, state, cfg, args.seed, dev, args.v3)
    if args.level:
        trainer.rebuild(params, args.level)
    trainer.step()  # warm-up
    torch.cuda.synchronize()
    stage_ms = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        timer = cs.StageTimer()
        trainer.step(stage=timer)
        stage_ms.append(timer)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    stage_ms = [t.ms() for t in stage_ms]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            trainer.step(stage=cs.StageTimer())
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device time of kernels, memcpys and memsets (device-side events;
    # the aten ops that launched them and the phase ranges spanning them
    # would count the same time again)
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key not in stage_ms[0])
    summary = {
        "steps": args.steps,
        "activate_level": args.level,
        "tile_px": cs.tile_of(args.v3),
        "kmax": cfg.kmax,
        "views": cs.MV,
        "wall_ms_per_step": 1e3 * wall_s / args.steps,
        "device_busy_ms_per_step": device_us / 1e3 / args.steps,
        "device_busy_share": device_us / 1e6 / wall_s,
        "stage_ms_mean": {k: float(np.mean([s[k] for s in stage_ms]))
                          for k in stage_ms[0]},
        "card": card,
    }
    by_device = events.table(sort_by="self_device_time_total", row_limit=40)
    by_host = events.table(sort_by="self_cpu_time_total", row_limit=25)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(summary, indent=1) + "\n\n" + by_device
                     + "\n\n" + by_host + "\n")
    print(json.dumps(summary))
    print(by_device)


if __name__ == "__main__":
    main()
