#!/usr/bin/env python
"""Micro-probes of the mechanics a Hopper blend kernel rests on, the port
of tools/micro_mosaic.py to splatco_torch's CUDA probes
(splatco_torch/ops/probes.py):

  1. cumsum as the product L x, on the tensor cores in TF32 and in fp32,
     against numpy's float32 cumsum (relative to its max |value|),
  2. the window data[:, p : p + 128] at an arbitrary element offset p,
     summed per row, by three mechanisms (direct, smem, shfl), against
     the JAX tool's numpy row sums,
  3. accumulation over 4 sequential steps into a pre-zeroed buffer
     (in place; 2.0 expected),
  4. the alpha-sum probe at kernel scale (8192 chunks), records from the
     aligned block or from the window at p = 128 c + 7: time only, on
     the JAX tool's own inputs.

The inputs come from np.random.default_rng(0) drawn in the JAX tool's
order (data, starts, xs, big), so they equal its inputs.

    python tools/micro_mosaic_torch.py [--device cpu] [--iters N]

It runs on the card; each probe is timed with CUDA events over --iters
launches queued behind a sleep kernel after a warm-up
(splatco_torch.utils.measure.cuda_time_ms): the device time, not the
rate at which Python launches these microsecond kernels.  With --device cpu it runs
the plain versions and skips the timing and probe 4, as the JAX tool's
--device cpu does.  Exits 1 if any probe fails its bound.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from splatco_torch.ops import probes  # noqa: E402
from splatco_torch.utils.device import resolve_device  # noqa: E402
from splatco_torch.utils.measure import cuda_time_ms  # noqa: E402

N_CHUNKS = 64
N_BIG = 8192
# bounds: the JAX tool's for the row sums (float32 sums in another order
# than numpy's pairwise one); the fp32 cumsum adds in numpy's order; TF32
# keeps 10 mantissa bits of each input: 5e-4 sits above its measured
# 1.9e-4 and below the ~1.5e-3 of inputs rounded to bf16
EXTRACT_TOL = 1e-4
CUMSUM_TOL = {"tf32": 5e-4, "fp32": 1e-6}


def inputs() -> dict:
    """The JAX tool's inputs as numpy arrays, drawn in its order."""
    rng = np.random.default_rng(0)
    s = N_CHUNKS * probes.WIN
    data = rng.normal(size=(probes.REC, s + probes.WIN)).astype(np.float32)
    starts = np.sort(rng.integers(0, s - 1, size=N_CHUNKS)).astype(np.int32)
    xs = rng.normal(size=(128, 256)).astype(np.float32)
    big = rng.normal(size=(probes.REC, N_BIG * probes.WIN + probes.WIN)
                     ).astype(np.float32)
    st2 = (np.arange(N_BIG) * probes.WIN + 7).astype(np.int32)
    return {"data": data, "starts": starts, "xs": xs, "big": big,
            "st2": st2}


def expected_row_sums(data: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The JAX tool's `expected()`: [n, 16] numpy float32 window sums."""
    return np.stack([data[:, p:p + probes.WIN].sum(axis=1)
                     for p in starts.tolist()])


def run(dev: torch.device, iters: int = 20) -> dict:
    """Run every probe and mode on `dev`, print one line each and return
    {probe line key: {"err", "ok", "ms"}} (ms None off the card)."""
    timing = dev.type == "cuda"
    inp = inputs()
    out = {}

    def ms_of(fn):
        return cuda_time_ms(fn, iters) if timing else None

    def show(ms, n=None):
        if ms is None:
            return ""
        per = f" ({ms / n * 1e3:.3f} us/chunk)" if n else ""
        return f"  {ms:.4f} ms{per}"

    xs = torch.as_tensor(inp["xs"], device=dev)
    ref = np.cumsum(inp["xs"], axis=0)
    for mode in probes.CUMSUM_MODES:
        got = probes.cumsum_rows(xs, mode).cpu().numpy()
        rel = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
        ok = rel <= CUMSUM_TOL[mode]
        ms = ms_of(lambda: probes.cumsum_rows(xs, mode))
        out[f"cumsum[{mode}]"] = {"err": rel, "ok": ok, "ms": ms}
        print(f"cumsum-matmul mode={mode:5s} rel_err={rel:.2e}  "
              f"{'OK' if ok else 'FAIL'}{show(ms)}")

    data = torch.as_tensor(inp["data"], device=dev)
    starts = torch.as_tensor(inp["starts"], device=dev)
    exp = expected_row_sums(inp["data"], inp["starts"])
    for mode in probes.EXTRACT_MODES:
        got = probes.extract_rows(data, starts, mode).cpu().numpy()
        err = float(np.abs(got[:, 0] - exp).max())
        ok = err < EXTRACT_TOL and not got[:, 1:].any()
        ms = ms_of(lambda: probes.extract_rows(data, starts, mode))
        out[f"extract[{mode}]"] = {"err": err, "ok": ok, "ms": ms}
        print(f"extract[{mode:8s}]  max_err={err:.2e}  "
              f"{'OK' if ok else 'FAIL'}{show(ms)}")

    acc = torch.zeros((8, 128), device=dev)
    ones = torch.ones((8, 128), device=dev)
    probes.accumulate_(acc, ones)
    got = float(acc[0, 0])
    ok = bool((acc == 2.0).all())
    ms = ms_of(lambda: probes.accumulate_(acc, ones))
    out["accum"] = {"err": abs(got - 2.0), "ok": ok, "ms": ms}
    print(f"io-alias zero-init  out={got}  {'OK' if ok else 'FAIL'}"
          f"{show(ms)}")

    if timing:
        big = torch.as_tensor(inp["big"], device=dev)
        st2 = torch.as_tensor(inp["st2"], device=dev)
        for extract in probes.BLEND_MODES:
            ms = ms_of(lambda: probes.alpha_sums(big, st2, extract))
            out[f"blend[extract={extract}]"] = {"err": None, "ok": True,
                                                "ms": ms}
            print(f"blend-kernel extract={extract}:{show(ms, N_BIG)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the card")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    results = run(resolve_device(args.device), args.iters)
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
