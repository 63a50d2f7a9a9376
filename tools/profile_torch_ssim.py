"""Time the SSIM of one view on the card, as the training step calls it:
the device time of its forward and backward, the kernels each launches
and the memory its forward keeps for the backward.  (chip_smoke.py
phase 22 times each SSIM kernel alone; `tools/profile_torch_train.py`'s
`ssim` range, SSIM's device time in whole training steps.)

    PYTHONPATH=. python tools/profile_torch_ssim.py [--height 1088]
        [--width 1600] [--reps 20] [--out PATH]

The view is a seeded [3, H, W] image that needs a gradient, as a rendered
view does, against a seeded target: `1 - ssim(image, gt)` forward, then
its backward.  Each timed run is queued behind a ~50 ms sleep kernel, so
CUDA events time the device's work, not the host's launches.  The kernel
counts are torch.profiler's device events (kernels, memsets, memcpys) of
one forward and of one backward.  Prints one JSON line (and writes it
to PATH with --out).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from splatco_torch.ops import losses
from splatco_torch.utils.measure import SLEEP_CYCLES


def device_events(fn) -> int:
    """Device events (kernels, memsets, memcpys) of one call of fn."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation)


def forward_backward_ms(img, gt, reps: int):
    """Mean device ms of the forward and of the backward of
    1 - ssim(img, gt), each rep queued behind a sleep kernel."""
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(reps + 1)]
    for e0, e1, e2 in events:
        img.grad = None
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        loss = 1.0 - losses.ssim(img, gt)
        e1.record()
        loss.backward()
        e2.record()
    torch.cuda.synchronize()
    timed = events[1:]  # the first is a warm-up
    return (float(np.mean([a.elapsed_time(b) for a, b, _ in timed])),
            float(np.mean([b.elapsed_time(c) for _, b, c in timed])))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_ssim: no CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    shape = (3, args.height, args.width)
    gt = torch.as_tensor(rng.uniform(size=shape).astype(np.float32),
                         device=dev)
    img = torch.as_tensor(np.clip(gt.cpu().numpy() + rng.normal(
        scale=0.1, size=shape), 0, 1).astype(np.float32),
        device=dev).requires_grad_()

    fwd_ms, bwd_ms = forward_backward_ms(img, gt, args.reps)
    fwd_events = device_events(lambda: losses.ssim(img, gt))
    loss = 1.0 - losses.ssim(img, gt)
    bwd_events = device_events(lambda: loss.backward())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = 1.0 - losses.ssim(img, gt)
    torch.cuda.synchronize()
    kept_mib = (torch.cuda.memory_allocated() - base) / 2 ** 20
    loss.backward()
    del loss
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    summary = {
        "card": card, "torch": torch.__version__, "image": list(shape),
        "reps": args.reps,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "forward_device_events": fwd_events,
        "backward_device_events": bwd_events,
        "kept_for_backward_mib": kept_mib,
        "forward_backward_peak_mib": peak_mib,
    }
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
