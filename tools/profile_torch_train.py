"""Profile the splatco_torch training step on the card at chip_smoke.py's
training size: per-phase CUDA-event times, the device's busy share, and
torch.profiler's kernel table.

    PYTHONPATH=. python tools/profile_torch_train.py [--steps 3]
        [--level 0] [--v3] [--disk] [--out PATH]

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

--disk profiles chip_smoke.py's phase 16 instead: `train_torch.main`
trains the quick-start model on phase 15's scene with phase 16's flags,
and `--steps` steps from step 72 on (kmax 32, capacity 131,072, after
the graph downsample) run under torch.profiler.  Its busy share is their
device time over the mean CUDA-event time of the other steps from 31 on
(neither the staged nor a profiled one).  It also prints the table of
operators by their device time, children included: each autograd
node's `evaluate_function` row holds its backward's kernels.

The tri-plane sampler's forward and backward run inside
`record_function("plane_sample")` ranges, the tile binning's three
kernels inside `record_function("binning")` and the backward's slot
reduce inside `record_function("slot_reduce")` (ops/rasterize.py), SSIM
inside `record_function("ssim")` ranges (ops/losses.py), the EWA
projection inside `record_function("projection")` ranges
(ops/projection.py): the summary's
`<range>_device_ms_per_step` is the device time of the kernels, memsets
and memcpys inside the range's spans on the device,
`<range>_device_span_ms_per_step` those spans themselves (first kernel's
start to last one's end, the gaps between them included), which is also
the range's row of the tables, and `<range>_kernels_per_step` the
device operations inside the spans.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time
import types

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
    ap.add_argument("--disk", action="store_true",
                    help="profile chip_smoke.py's phase 16 (train_torch)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.disk:
        summary, events = profile_disk(args, dev)
        summary["card"] = card
        report(summary, events, args.out, by_op=True)
        return
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
    device_us = device_time_us(events, skip=stage_ms[0])
    summary = {
        "steps": args.steps,
        "activate_level": args.level,
        "tile_px": cs.tile_of(args.v3),
        "kmax": cfg.kmax,
        "views": cs.MV,
        "wall_ms_per_step": 1e3 * wall_s / args.steps,
        "device_busy_ms_per_step": device_us / 1e3 / args.steps,
        "device_busy_share": device_us / 1e6 / wall_s,
        **range_device_ms(prof.events(), args.steps),
        "stage_ms_mean": {k: float(np.mean([s[k] for s in stage_ms]))
                          for k in stage_ms[0]},
        "card": card,
    }
    report(summary, events, args.out)


FIRST_PROFILED = 72


def profile_disk(args, dev):
    """chip_smoke.py's phase 16 with steps FIRST_PROFILED.. profiled:
    (summary, the profiler's key_averages)."""
    import train_torch

    profiled = range(FIRST_PROFILED, FIRST_PROFILED + args.steps)
    probe = cs.TrainProbe(staged_step=cs.TRAIN_STAGED, profiled=profiled)
    with tempfile.TemporaryDirectory() as tmp:
        scene = cs.write_scene(tmp, types.SimpleNamespace(seed=args.seed),
                               dev)
        with probe.installed():
            trainer = train_torch.main(
                ["-s", scene, *cs.TRAIN_ARGS, "--seed", str(args.seed),
                 "-m", os.path.join(tmp, "model")])
    step_ms = probe.step_ms()
    later = [ms for n, ms in enumerate(step_ms, 1)
             if n > 30 and n != cs.TRAIN_STAGED and n not in profiled]
    events = probe.profiler.key_averages()
    device_us = device_time_us(events)
    summary = {
        "profiled_steps": list(profiled),
        "kmax": trainer.cfg.kmax,
        "capacity": trainer.params["anchors"]["anchor"].shape[0],
        "anchors": int(trainer.mstate.active.sum()),
        "views": cs.MV,
        "profiled_event_ms": [step_ms[n - 1] for n in profiled],
        "other_steps_from_31_mean_ms": float(np.mean(later)),
        "device_busy_ms_per_step": device_us / 1e3 / len(profiled),
        "device_busy_share": device_us / 1e3 / len(profiled)
        / float(np.mean(later)),
        **range_device_ms(probe.profiler.events(), len(profiled)),
        "staged_step": cs.TRAIN_STAGED,
        "stage_ms": probe.stages.ms(),
    }
    return summary, events


def device_time_us(events, skip=()) -> float:
    """Device time of kernels, memcpys and memsets (device-side events;
    the aten ops that launched them and the ranges spanning them, the
    `record_function` ones on the device too, would count the same time
    again)."""
    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and e.key not in skip)


RANGES = ("plane_sample", "binning", "slot_reduce", "ssim", "projection")


def range_device_ms(raw, steps: int) -> dict:
    """Device ms a step of each of RANGES, from the profiler's raw events:
    the tri-plane sampler (ops/plane_sample.py: its forward kernel, and
    its backward's memset and three kernels), the binning
    (ops/binning.py: bin_count, bin_place, bin_sort_tiles, their memsets
    and the read-back of the pair count), the slot reduce
    (ops/rasterize.py) and SSIM (ops/losses.py: forward, the stack of
    moments, the blur and the map; backward, the map's VJP and the
    blur, each in its own range) and the EWA projection
    (ops/projection.py: the prefilter's, the render's and their
    backward).  `_device_ms`: the device time of the work inside the
    range's device-side spans; `_device_span_ms`: the spans;
    `_kernels`: the kernels, memsets and memcpys inside them."""
    cuda = torch.autograd.DeviceType.CUDA
    on_device = [e for e in raw if e.device_type == cuda]
    work = [(e.time_range.start, e.time_range.end) for e in on_device
            if not e.is_user_annotation]
    out = {}
    for name in RANGES:
        spans = [(e.time_range.start, e.time_range.end) for e in on_device
                 if e.is_user_annotation and e.name == name]
        busy = sum(min(b, hi) - max(a, lo) for lo, hi in spans
                   for a, b in work if a < hi and b > lo)
        out[f"{name}_device_ms_per_step"] = busy / 1e3 / steps
        out[f"{name}_device_span_ms_per_step"] = sum(
            hi - lo for lo, hi in spans) / 1e3 / steps
        out[f"{name}_kernels_per_step"] = sum(
            1 for a, b in work
            if any(lo <= a and b <= hi for lo, hi in spans)) / steps
    return out


def report(summary, events, out, by_op=False) -> None:
    by_device = events.table(sort_by="self_device_time_total", row_limit=40)
    by_host = events.table(sort_by="self_cpu_time_total", row_limit=25)
    tables = [by_device]
    if by_op:
        tables.append(events.table(sort_by="device_time_total",
                                   row_limit=60))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            fh.write("\n\n".join([json.dumps(summary, indent=1), *tables,
                                   by_host]) + "\n")
    print(json.dumps(summary))
    for table in tables:
        print(table)


if __name__ == "__main__":
    main()
