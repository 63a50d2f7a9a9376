"""Profile the splatco_torch render on the card at chip_smoke.py's
main-path size: per-stage CUDA-event times, the device's busy share, and
torch.profiler's kernel table.

    PYTHONPATH=. python tools/profile_torch_render.py [--frames 4] [--v3]
        [--out PATH]

Prints the summary and the kernel table; with --out it also writes them
and the host-time table to PATH.  --v3 renders in the v3 configuration
(16 px tiles, kmax 32, as chip_smoke.py's phase 12).

Frames are rendered stage by stage (chip_smoke.frame_stages: prefilter,
decode, projection, binning (ops/binning.py's three kernels), blend),
each in a `record_function` range of its name, after one warm-up pass
over the cameras: once timed with the host clock (wall) and
CUDA events (stages), then once more under torch.profiler.  The busy
share is the profiled device time of all kernels, memcpys and memsets
over the unprofiled wall time (one stream, so kernels do not overlap).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from splatco_torch.models.splatco import init_model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--v3", action="store_true",
                    help="16 px tiles (tile16=True) with kmax 32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    cfg = cs.quickstart_config()
    if args.v3:
        cfg = dataclasses.replace(cfg, kmax=cs.KMAX_V3)
    pts = np.random.default_rng(args.seed).normal(
        size=(65536, 3)).astype(np.float32) * 1.2
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    cams = cs.orbit_cameras(args.frames, dev)
    level = 2
    with torch.inference_mode():
        for cam in cams:  # warm-up
            cs.frame_stages(params, state, cam, cfg, level, args.v3)
        torch.cuda.synchronize()
        stage_ms = []
        t0 = time.perf_counter()
        for cam in cams:
            stage_ms.append(cs.frame_stages(params, state, cam, cfg,
                                            level, args.v3)[1])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for cam in cams:
                cs.frame_stages(params, state, cam, cfg, level, args.v3)
            torch.cuda.synchronize()
    events = prof.key_averages()
    # device time of kernels, memcpys and memsets (device-side events;
    # the aten ops that launched them, the stage ranges and the sampler's
    # `plane_sample` ranges spanning them would count the same time again)
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation
                    and e.key not in stage_ms[0])
    summary = {
        "frames": args.frames,
        "tile_px": cs.tile_of(args.v3),
        "kmax": cfg.kmax,
        "wall_ms_per_frame": 1e3 * wall_s / args.frames,
        "device_busy_ms_per_frame": device_us / 1e3 / args.frames,
        "device_busy_share": device_us / 1e6 / wall_s,
        "stage_ms_mean": {k: float(np.mean([s[k] for s in stage_ms]))
                          for k in stage_ms[0]},
        "card": torch.cuda.get_device_name(0),
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
