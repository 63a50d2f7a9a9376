"""The "train" traffic driver: the SVC training step in a closed loop, as
the trainer calls it (splatco_torch/train/loop.py `Trainer.train`).

Each step takes `views_per_step` views drawn without replacement from a
viewpoint stack of the orbit's cameras by `random.Random` (refilled when
empty), in the trainer's order (sorted by resolution); their smooth
targets; the pair gates, cached per camera pair and filled in set-up;
the iteration's loss terms (consistency inside the update window, the
TV term every `tv_every`-th iteration, statistics from `start_stat`).
The step's metrics stay on the device and are read after the window.

Set-up builds the step and its state once and drives its first
`check_steps` steps through the window's own call; the window goes on
from that state.  The check replays those steps in the reference.
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List, Optional

import torch

from bench_h100.harness import cell as C
from bench_h100.harness import check, inputs
from bench_h100.harness import program as prog
from bench_h100.harness import trace as T
from bench_h100.reference import model as rm
from bench_h100.reference.numerics import Numerics
from bench_h100.reference.step import RefTrainer, leaves, scene_extent
from bench_h100.reference.step import ssim as ref_ssim

ADAM_B1 = 0.9


def seeds(seed: int) -> Dict[str, int]:
    """The seed's streams: the scene (harness/inputs.py), targets,
    quantization noise, views."""
    return {"scene": seed, "targets": seed + 1, "noise": seed + 2,
            "views": seed + 3}


class ViewSampler:
    """The trainer's view sampling: without replacement from a stack."""

    def __init__(self, n: int, per_step: int, seed: int):
        self.n, self.per_step = n, per_step
        self.rng = random.Random(seed)
        self.stack: List[int] = []

    def next(self) -> List[int]:
        out = []
        for _ in range(self.per_step):
            if not self.stack:
                self.stack = list(range(self.n))
            pick = self.rng.randint(0, len(self.stack) - 1)
            out.append(self.stack.pop(pick))
        return out  # one resolution: sorting by it keeps this order


def terms(traffic: Dict, it: int):
    """(consistency_on, tv_w, stats_on) of iteration `it`."""
    t = traffic["terms"]
    consistency = float(t["update_from"] < it < t["update_until"])
    tv_w = t["tv_weight"] if it % t["tv_every"] == 0 else 0.0
    stats = float(t["start_stat"] < it < t["update_until"])
    return consistency, tv_w, stats


class StageTimer:
    """The step's `stage` hook: CUDA events and a profiler range around
    each phase, read after the window."""

    def __init__(self):
        self.marks: List = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with torch.profiler.record_function(name):
            yield
        b.record()
        self.marks.append((name, a, b))

    def per_unit(self, units: int) -> Dict[str, List[float]]:
        """phase -> ms summed over each unit's marks (marks in order,
        `units` equal groups)."""
        torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        per = len(self.marks) // max(units, 1)
        for u in range(units):
            sums: Dict[str, float] = {}
            for name, a, b in self.marks[u * per:(u + 1) * per]:
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
            for name, ms in sums.items():
                out.setdefault(name, []).append(ms)
        return out


class TrainRun:
    """The program's training state and the traffic that feeds it."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int,
                 dev: torch.device):
        s = seeds(seed)
        self.traffic, self.dev = traffic, dev
        self.program = prog.Program(cfg, dev)
        self.cams = self.program.cameras(inputs.orbit(cfg, traffic))
        self.targets = inputs.smooth_targets(cfg, len(self.cams), s["targets"],
                                             dev)
        self.params = inputs.make_params(cfg, s["scene"], dev)
        self.initial = self.params
        centres = torch.stack([c.camera_center for c in self.cams]).double()
        self.extent = 1.1 * float((centres - centres.mean(dim=0))
                                  .norm(dim=1).max())
        self.iteration = traffic["first_iteration"]
        self.step_fn, self.opt_state, self.stats = self.program.train_step(
            self.params, traffic["views_per_step"], traffic["activate_level"],
            traffic["q_noise"], self.extent, self.iteration)
        self.generator = torch.Generator(device=dev).manual_seed(s["noise"])
        self.sampler = ViewSampler(len(self.cams), traffic["views_per_step"],
                                   s["views"])
        self.gates = self._gates()
        self.history: List[List[int]] = []

    def _gates(self) -> Dict:
        """The consistency gates of every camera pair, by the program's
        SSIM, fetched once."""
        n = len(self.targets)
        pairs = [(a, b) for a in range(n) for b in range(a, n)]
        vals = torch.stack([prog.ssim(self.targets[a], self.targets[b])
                            for a, b in pairs]).cpu().tolist()
        return dict(zip(pairs, vals))

    def gate_list(self, idx: List[int]) -> List[float]:
        return [self.gates[(min(idx[i], idx[j]), max(idx[i], idx[j]))]
                for i in range(len(idx)) for j in range(i + 1, len(idx))]

    def call(self, stage=None):
        """One step through the window's call and feed; returns its
        metrics (on the device)."""
        idx = self.sampler.next()
        self.history.append(idx)
        cons, tv_w, stats_on = terms(self.traffic, self.iteration)
        gates = torch.tensor(self.gate_list(idx), dtype=torch.float32,
                             device=self.dev)
        self.params, self.opt_state, self.stats, metrics = self.step_fn(
            self.params, self.opt_state, self.program.state.active,
            self.program.state.contractor, self.stats,
            [self.cams[i] for i in idx], [self.targets[i] for i in idx],
            self.program.bg, self.generator, self.iteration, cons, tv_w,
            stats_on, gates, stage)
        self.iteration += 1
        return metrics


def first_steps(run: TrainRun, n: int) -> Dict:
    """Drives the first n steps and records what the check compares: each
    step's loss, the first gradient's norm per leaf (from Adam's first
    moment after step 1) and each leaf's change after the n steps."""
    losses = []
    grad_norms = None
    for k in range(n):
        losses.append(run.call()["loss"])
        if k == 0:
            grad_norms = {
                p: torch.linalg.vector_norm(m.double()) / (1 - ADAM_B1)
                for p, m in leaves(run.opt_state["mu"]).items()}
    before = leaves(run.initial)
    change = {p: torch.linalg.vector_norm((v - before[p]).double())
              for p, v in leaves(run.params).items()}
    run.initial = None
    return {"losses": [float(v) for v in losses],
            "grad_norms": {k: float(v) for k, v in grad_norms.items()},
            "change_norms": {k: float(v) for k, v in change.items()},
            "views": [list(v) for v in run.history[:n]],
            "iterations": list(range(run.traffic["first_iteration"],
                                     run.traffic["first_iteration"] + n))}


def window(run: TrainRun, seconds: float, stage: Optional[StageTimer] = None
           ) -> Dict:
    """The measured window: steps back to back until `seconds` have
    passed on the host's clock, then a synchronize."""
    C.sync(run.dev)
    pending = []
    stamps = []
    first = len(run.history)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pending.append(run.call(stage)["loss"])
        stamps.append(time.perf_counter() - t0)
    C.sync(run.dev)
    wall = time.perf_counter() - t0
    C.per_second(stamps, wall)
    losses = torch.stack(pending).cpu() if pending else torch.zeros(0)
    return {"wall_s": wall, "steps": len(pending),
            "failed": int((~torch.isfinite(losses)).sum()),
            "views": run.history[first:]}


def reference_steps(cfg: Dict, traffic: Dict, seed: int, record: Dict,
                    dev: torch.device, precision: str = "fp32"):
    """The reference's replay of the recorded first steps from the same
    inputs, made again from the seed: (its record, the RefTrainer, its
    cameras)."""
    s = seeds(seed)
    num = Numerics(precision)
    params = inputs.make_params(cfg, s["scene"], dev)
    before = {k: v.clone() for k, v in leaves(params).items()}
    bounds = inputs.scene_bounds(cfg, dev)
    cams = [rm.look_at(device=dev, **v) for v in inputs.orbit(cfg, traffic)]
    targets = inputs.smooth_targets(cfg, len(cams), s["targets"], dev)
    white = cfg["scene"]["white_background"]
    bg = torch.full((3,), 1.0 if white else 0.0, device=dev)
    active = torch.ones(cfg["scene"]["anchors"], dtype=torch.bool, device=dev)
    rcfg = {"activate_level": traffic["activate_level"],
            "tile": cfg["render"]["tile"], "kmax": cfg["render"]["kmax"],
            "q_noise": traffic["q_noise"]}
    trainer = RefTrainer(params, active, bounds, bg, rcfg,
                         cfg["optimization"], scene_extent(cams),
                         traffic["first_iteration"], num)
    gen = torch.Generator(device=dev).manual_seed(s["noise"])
    losses, grad_norms = [], {}
    for k, (idx, it) in enumerate(zip(record["views"],
                                      record["iterations"])):
        cons, tv_w, _ = terms(traffic, it)
        gts = [targets[i] for i in idx]
        gates = [float(ref_ssim(gts[i], gts[j], num))
                 for i in range(len(idx)) for j in range(i + 1, len(idx))]
        out = trainer.step([cams[i] for i in idx], gts, gates, cons, tv_w,
                           gen)
        losses.append(out["loss"])
        if k == 0:
            grad_norms = {p: float(torch.linalg.vector_norm(g.double()))
                          for p, g in out["grads"].items()}
    change = {p: float(torch.linalg.vector_norm((v - before[p]).double()))
              for p, v in trainer.params.items()}
    return ({"losses": losses, "grad_norms": grad_norms,
             "change_norms": change}, trainer, cams)


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float) -> Dict:
    """One run (harness/cell.py): set-up and the checked first steps, the
    window (or the traced window after `trace_warmup` steps), the
    reference's replay."""
    run_ = TrainRun(cfg, traffic, seed, dev)
    record = first_steps(run_, traffic["check_steps"])
    C.sync(dev)
    setup_peak = C.peak(dev)
    setup_s = time.perf_counter() - t_start
    t_window = C.log("set-up", t_start)
    stage = StageTimer() if trace and dev.type == "cuda" else None
    with C.profiled(trace, dev) as prof:
        if trace:
            for _ in range(traffic["trace_warmup"]):
                run_.call(stage)
            C.sync(dev)
            if stage is not None:
                stage.marks.clear()
        C.reset_peak(dev)
        with torch.profiler.record_function(C.WINDOW_RANGE):
            win = window(run_, C.TRACE_SECONDS if trace else seconds, stage)
    window_peak = C.peak(dev)
    t = C.log("window", t_window)
    C.check_modules()
    stages = stage.per_unit(win["steps"]) if stage is not None else {}
    del run_
    C.free(dev)
    ref, trainer, ref_cams = reference_steps(cfg, traffic, seed, record,
                                             dev)
    numbers = check.train_numbers(record["losses"], ref["losses"],
                                  record["grad_norms"], ref["grad_norms"],
                                  record["change_norms"],
                                  ref["change_norms"])
    ok, rows = check.judge(numbers, traffic["limits"])
    t = C.log("reference", t)
    if trace:
        window_ = T.Window(**C.window_events(prof), units=win["steps"],
                           unit_views=win["views"], stages=stages,
                           counts=C.counts(cfg, traffic["activate_level"],
                                           trainer.tree(), ref_cams, dev),
                           kind="train")
        C.log("counts and trace", t)
    else:
        window_ = T.Window([], [], [], win["wall_s"], win["steps"],
                           win["views"], {}, kind="train", setup_s=setup_s,
                           peak_bytes=window_peak)
    return {"window": window_, "correct": ok and win["failed"] == 0,
            "attempted": win["steps"], "failed": win["failed"],
            "checks": rows, "peak": max(setup_peak, window_peak)}


def readings(cfg: Dict, traffic: Dict, seed: int, dev: torch.device,
             control: bool, faults) -> Dict[str, Dict]:
    """calibrate.py's readings: the check's numbers for the program, each
    planted fault and (with `control`) the reference computed with TF32
    products in the program's place."""
    from bench_h100.harness import faults as fl
    n = traffic["check_steps"]
    records = {}
    run_ = TrainRun(cfg, traffic, seed, dev)
    records["program"] = first_steps(run_, n)
    del run_
    for f in faults:
        C.free(dev)
        with fl.planted(f):
            run_ = TrainRun(cfg, traffic, seed, dev)
            records[f] = first_steps(run_, n)
            del run_
    C.free(dev)
    ref = reference_steps(cfg, traffic, seed, records["program"], dev)[0]
    if control:
        C.free(dev)
        records["control"] = reference_steps(
            cfg, traffic, seed, records["program"], dev, "tf32")[0]
    return {k: check.train_numbers(r["losses"], ref["losses"],
                                   r["grad_norms"], ref["grad_norms"],
                                   r["change_norms"], ref["change_norms"])
            for k, r in records.items()}
