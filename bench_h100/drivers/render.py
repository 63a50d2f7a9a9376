"""The "render" traffic driver: one client in a closed loop asks for the
orbit's frames in order, again and again, as the render driver and the
viewer draw them (splatco_torch/eval/render_driver.py `render_set`): the
anchor prefilter and `render` under inference mode, then the frame
clamped and converted to 8-bit RGB on the device and copied into its
camera's reused host buffer before the next frame is asked for.

A frame's latency runs from its request to its 8-bit image in host
memory; a frame whose image is not finite has failed.  Set-up renders
every camera once through the same call; the buffers are then cleared,
so each holds the last frame the window drew from its camera, which the
check compares with the reference.  With a trace, an untraced stretch of
LATENCY_SECONDS comes first and gives the latencies: the profiler's own
host work would be most of a traced frame's tail."""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from bench_h100.harness import cell as C
from bench_h100.harness import check, inputs
from bench_h100.harness import program as prog
from bench_h100.harness import trace as T
from bench_h100.reference import model as rm
from bench_h100.reference.numerics import Numerics
from bench_h100.reference.project import visible
from bench_h100.reference.step import eight_bit, render_view

# the untraced stretch of a traced run: some thousand frames, some tens of
# them past the 95th percentile
LATENCY_SECONDS = 10.0


def to_host_u8(img: torch.Tensor, out: torch.Tensor) -> None:
    """img [3, H, W] -> out [H, W, 3] uint8 on the host (pinned where
    there is a card), clamped and truncated on the device first."""
    out.copy_((img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
              .permute(1, 2, 0))


class RenderRun:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int,
                 dev: torch.device):
        self.traffic, self.dev = traffic, dev
        self.program = prog.Program(cfg, dev)
        self.cams = self.program.cameras(inputs.orbit(cfg, traffic))
        self.params = inputs.make_params(cfg, seed, dev)
        h, w = cfg["render"]["height"], cfg["render"]["width"]
        pin = dev.type == "cuda"
        self.buffers = [torch.zeros((h, w, 3), dtype=torch.uint8,
                                    pin_memory=pin) for _ in self.cams]

    def call(self, i: int) -> torch.Tensor:
        """Frame `i` into its host buffer; returns whether its image was
        finite (on the device)."""
        img = self.program.render(self.params, self.cams[i],
                                  self.traffic["activate_level"])
        to_host_u8(img, self.buffers[i])
        return torch.isfinite(img).all()


def warm_up(run: RenderRun) -> None:
    for i in range(len(run.cams)):
        run.call(i)
    C.sync(run.dev)
    for b in run.buffers:
        b.zero_()


def window(run: RenderRun, seconds: float) -> Dict:
    """Frames back to back until `seconds` have passed: (wall, frames,
    each frame's latency in ms, its camera, the frames not finite)."""
    C.sync(run.dev)
    lat: List[float] = []
    stamps: List[float] = []
    views: List[List[int]] = []
    finite: List[torch.Tensor] = []
    n = len(run.cams)
    t0 = time.perf_counter()
    i = 0
    while True:
        t_req = time.perf_counter()
        if t_req - t0 >= seconds:
            break
        finite.append(run.call(i % n))
        t_done = time.perf_counter()
        lat.append(1e3 * (t_done - t_req))
        stamps.append(t_done - t0)
        views.append([i % n])
        i += 1
    C.sync(run.dev)
    wall = time.perf_counter() - t0
    C.per_second(stamps, wall)
    failed = int((~torch.stack(finite)).sum()) if finite else 0
    return {"wall_s": wall, "frames": len(lat), "latency_ms": lat,
            "views": views, "failed": failed}


def sample(traffic: Dict, seed: int) -> List[int]:
    """The cameras whose last frames the check compares, from the seed."""
    rng = random.Random(seed + 7)
    return sorted(rng.sample(range(traffic["cameras"]),
                             traffic["check_frames"]))


def reference_frames(cfg: Dict, traffic: Dict, seed: int, which: List[int],
                     dev: torch.device, precision: str = "fp32"
                     ) -> List[torch.Tensor]:
    """The reference's 8-bit frames of cameras `which`, from inputs made
    again from the seed."""
    num = Numerics(precision)
    params = inputs.make_params(cfg, seed, dev)
    bounds = inputs.scene_bounds(cfg, dev)
    views = inputs.orbit(cfg, traffic)
    white = cfg["scene"]["white_background"]
    bg = torch.full((3,), 1.0 if white else 0.0, device=dev)
    active = torch.ones(cfg["scene"]["anchors"], dtype=torch.bool, device=dev)
    out = []
    with torch.no_grad():
        for i in which:
            cam = rm.look_at(device=dev, **views[i])
            vis = visible(params["anchors"], active, cam)
            img, _, _ = render_view(params, bounds, cam, bg, vis,
                                    traffic["activate_level"],
                                    cfg["render"]["tile"],
                                    cfg["render"]["kmax"], num)
            out.append(eight_bit(img).cpu())
    return out


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float) -> Dict:
    """One run (harness/cell.py): set-up, the window (with a trace, the
    untraced latency stretch, then the traced window after
    `trace_warmup` frames), the sampled frames against the
    reference's."""
    run_ = RenderRun(cfg, traffic, seed, dev)
    warm_up(run_)
    setup_peak = C.peak(dev)
    setup_s = time.perf_counter() - t_start
    t_window = C.log("set-up", t_start)
    stretch = (window(run_, min(seconds, LATENCY_SECONDS)) if trace
               else {"frames": 0, "failed": 0})
    with C.profiled(trace, dev) as prof:
        if trace:
            for i in range(traffic["trace_warmup"]):
                run_.call(i % len(run_.cams))
            C.sync(dev)
        C.reset_peak(dev)
        with torch.profiler.record_function(C.WINDOW_RANGE):
            win = window(run_, C.TRACE_SECONDS if trace else seconds)
    window_peak = C.peak(dev)
    t = C.log("window", t_window)
    C.check_modules()
    which = sample(traffic, seed)
    got = [run_.buffers[i].clone() for i in which]
    never = [i for i, b in zip(which, got) if not bool(b.any())]
    del run_
    C.free(dev)
    want = reference_frames(cfg, traffic, seed, which, dev)
    ok, rows = check.judge(check.image_numbers(got, want), traffic["limits"])
    t = C.log("reference", t)
    failed = win["failed"] + stretch["failed"]
    if trace:
        params = inputs.make_params(cfg, seed, dev)
        cams = [rm.look_at(device=dev, **v)
                for v in inputs.orbit(cfg, traffic)]
        window_ = T.Window(**C.window_events(prof), units=win["frames"],
                           unit_views=win["views"], stages={},
                           counts=C.counts(cfg, traffic["activate_level"],
                                           params, cams, dev),
                           kind="render", latency_ms=stretch["latency_ms"])
        C.log("counts and trace", t)
    else:
        window_ = T.Window([], [], [], win["wall_s"], win["frames"],
                           win["views"], {}, kind="render",
                           latency_ms=win["latency_ms"], setup_s=setup_s,
                           peak_bytes=window_peak)
    return {"window": window_, "correct": ok and not never and failed == 0,
            "attempted": win["frames"] + stretch["frames"],
            "failed": failed, "checks": rows,
            "peak": max(setup_peak, window_peak)}


def readings(cfg: Dict, traffic: Dict, seed: int, dev: torch.device,
             control: bool, faults) -> Dict[str, Dict]:
    """calibrate.py's readings: the check's numbers for the program's
    sampled frames, each planted fault's and (with `control`) the
    reference's computed with TF32 products."""
    from bench_h100.harness import faults as fl
    which = sample(traffic, seed)

    def frames():
        run_ = RenderRun(cfg, traffic, seed, dev)
        for i in which:
            run_.call(i)
        return [run_.buffers[i].clone() for i in which]

    got = {"program": frames()}
    for f in faults:
        with fl.planted(f):
            got[f] = frames()
    C.free(dev)
    want = reference_frames(cfg, traffic, seed, which, dev)
    if control:
        got["control"] = reference_frames(cfg, traffic, seed, which, dev,
                                          "tf32")
    return {k: check.image_numbers(v, want) for k, v in got.items()}
