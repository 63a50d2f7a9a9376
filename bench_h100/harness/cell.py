"""One run of one cell: the driver that the cell's traffic mix names
(drivers/<driver>.py) makes the set-up, the measured (or traced) window
and the check against the reference; the metrics of the result line are
those BENCHMARK.json gives the cell, each read from the window by its
reader (metrics/<name>.py).

A driver module has

    run(cfg, traffic, seed, seconds, trace, dev, t_start) -> dict:
        "window"     trace.Window: the measured window (with trace, its
                     events and counts; without, its wall time, units,
                     set-up time and memory peak)
        "correct", "attempted", "failed"
        "checks"     [(name, number, limit)]
        "peak"       the device allocator's peak over the run, in bytes
    readings(cfg, traffic, seed, dev, control, faults) -> dict:
        {"program" | "control" | <fault>: the numbers the check
        compares}, for calibrate.py

and the helpers below."""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench_h100.harness import inputs, spec
from bench_h100.harness import trace as T
from bench_h100.harness.counting import camera_counts
from bench_h100.reference.numerics import full_float32
from bench_h100.reference.step import leaves

# compared whole with the top-level name of every loaded module
FORBIDDEN = ("jax", "jaxlib", "flax", "splatco_tpu")
WINDOW_RANGE = "bench_window"
# the traced window's length: its units hold every phase many times, and a
# longer trace only takes longer to read
TRACE_SECONDS = 4.0


def log(what: str, t0: float) -> float:
    """Prints how long a part of the run took (standard error); returns
    the time now."""
    now = time.perf_counter()
    print(f"{what}: {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def check_modules() -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the run may not load: "
                           f"{found}")


def free(dev) -> None:
    """Releases the program's state before the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def per_second(stamps: List[float], wall: float) -> None:
    """Prints the units the host finished in each second of the window
    (standard error): drift inside a window shows there."""
    counts = [0] * (int(wall) + 1)
    for t in stamps:
        counts[int(t)] += 1
    print(f"units a second: {counts}", file=sys.stderr, flush=True)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


@contextlib.contextmanager
def profiled(enabled: bool, dev):
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def window_events(prof) -> Dict:
    """The trace's events inside the window's host range, with their
    correlation ids, and the window's length: trace.Window's `ops`,
    `ranges`, `host`, `op_corr`, `host_corr` and `window_s`."""
    ev = T.profile_events(prof)
    spans = [(s, e) for n, s, e in ev.host if n == WINDOW_RANGE]
    if not spans:
        raise RuntimeError("the traced window's range is not in the trace")
    ws, we = spans[0]

    def inside(evs, *ids):
        """The events that start in the window, and their ids."""
        keep = [k for k, e in enumerate(evs) if ws <= e[1] < we]
        return [[lst[k] for k in keep] for lst in (evs, *ids)]

    ops, op_corr = inside(ev.ops, ev.op_corr)
    host, host_corr = inside(ev.host, ev.host_corr)
    ranges, = inside(ev.ranges)
    return {"ops": ops, "ranges": ranges, "host": host, "op_corr": op_corr,
            "host_corr": host_corr, "window_s": (we - ws) / 1e9}


def counts(cfg: Dict, level: int, params, cams, dev) -> Dict:
    """The work of each camera's frame, counted by the reference on the
    cell's inputs (harness/counting.py), and the sizes the operation
    counts take."""
    anchors = cfg["scene"]["anchors"]
    active = torch.ones(anchors, dtype=torch.bool, device=dev)
    per_camera = camera_counts(params, inputs.scene_bounds(cfg, dev), cams,
                               active, level, cfg["render"]["tile"],
                               cfg["render"]["kmax"])
    n_params = sum(v.numel() for v in leaves(params).values())
    return {"per_camera": per_camera, "model": cfg["model"],
            "anchors": anchors, "level": level, "params": n_params}


def execute(bench: Dict, workload: str, seed: int, seconds: float,
            trace: bool, dev: torch.device, t_start: float,
            base: Optional[Path] = None) -> Dict:
    """The result of one run: the JSON line's fields ("metrics" the
    cell's end-to-end metrics, with trace its per-layer ones), "checks"
    [(name, number, limit)] and "peak"."""
    base = base or spec.BENCH_DIR
    w = spec.cell(bench, workload)
    cfg = spec.config(bench, w["config"], base.parent)
    traffic = spec.traffic(w["traffic"], base)
    full_float32()
    out = spec.driver(traffic["driver"], base).run(
        cfg, traffic, seed, seconds, trace, dev, t_start)
    window = out.pop("window")
    out["metrics"] = spec.read_metrics(
        bench, workload, "per_layer" if trace else "end_to_end", window,
        base)
    if trace:
        out.update(breakdown=T.breakdown(window),
                   busy_s=T.busy_ns(window) / 1e9,
                   window_s=window.window_s)
    check_modules()
    return out
