"""Device timing and work bounds for the port's kernels, shared by
chip_smoke.py and the tools that time kernels (tools/micro_mosaic_torch.py,
tools/profile_torch_kernel_v3.py)."""
from __future__ import annotations

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, fp32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12  # dense, on the tensor cores
# the special-function unit (MUFU: ex2, rcp, rsqrt, lg2, sin, cos) gives
# 16 results a clock an SM at compute capability 9.0 (CUDA C++
# Programming Guide, "Arithmetic Instructions", the throughput table of
# native arithmetic instructions); 132 SMs at the SM's maximum clock,
# 1,980 MHz on an H100 SXM (nvidia-smi --query-gpu=clocks.max.sm)
SM_COUNT = 132
SFU_PER_CLOCK_SM = 16
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_SFU_PER_S = SM_COUNT * SFU_PER_CLOCK_SM * MAX_SM_CLOCK_HZ
# fp32/SFU operations per pixel evaluation of a record (dx, dy, power,
# compare, exp, alpha, clamp, compare) and per contribution (1 - alpha,
# T (1 - alpha), compare, w, three colour multiply-adds)
OPS_PER_EVAL = 16
OPS_PER_CONTRIB = 10
# the backward: the forward's replay per pixel evaluation; per
# contribution 1 - alpha, T (1 - alpha), compare, w, gc, prefix, dalpha,
# dpower, the six moment and three colour terms and the nine running sums;
# per record its nine gradients from the sums
OPS_PER_EVAL_BWD = 16
OPS_PER_CONTRIB_BWD = 35
OPS_PER_RECORD_BWD = 12
# cycles of the sleep kernel the timed runs queue behind (~50 ms)
SLEEP_CYCLES = 100_000_000


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back runs (CUDA
    events), after one warm-up run.  The runs are queued behind a sleep
    kernel, so a kernel shorter than its launch from Python is timed by
    the device, not by the host's launch rate; a fn that synchronises is
    timed with its host gaps, as without the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_terms(n_bytes: int, n_ops: int,
                peak_ops_per_s: float = PEAK_FP32_PER_S, n_sfu: int = 0,
                peak_sfu_per_s: float = PEAK_SFU_PER_S) -> dict:
    """ms of each term of a bound: `operations` at their type's peak
    rate (default fp32), `sfu` results (an exp's MUFU.EX2, ...) at the
    special-function unit's rate, `bytes` at the memory rate."""
    return {"operations": 1e3 * n_ops / peak_ops_per_s,
            "sfu": 1e3 * n_sfu / peak_sfu_per_s,
            "bytes": 1e3 * n_bytes / PEAK_BYTES_PER_S}


def bound(n_bytes: int, n_ops: int, peak_ops_per_s: float = PEAK_FP32_PER_S,
          n_sfu: int = 0, peak_sfu_per_s: float = PEAK_SFU_PER_S):
    """(ms, what bounds it): the largest of `bound_terms`, "bytes" or
    "operations" (the SFU's results are operations too)."""
    terms = bound_terms(n_bytes, n_ops, peak_ops_per_s, n_sfu, peak_sfu_per_s)
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations"


def fwd_bound(binned, work, tiles_x, tiles_y, tile):
    """The blend's bound on these inputs: each record read once (9
    floats), each tile's range, rgb and T written once per pixel; the
    operations of the evaluations and contributions `work` counted."""
    pairs = binned.records.shape[1]
    n_bytes = (9 * 4 * pairs + 2 * 4 * tiles_x * tiles_y
               + 4 * 4 * tiles_x * tiles_y * tile * tile)
    evals, contribs = int(work["evals"]), int(work["contribs"])
    bnd = bound(n_bytes, OPS_PER_EVAL * evals + OPS_PER_CONTRIB * contribs)
    print(f"{tile} px blend work: {pairs} pairs, {evals} pixel evaluations, "
          f"{contribs} contributions, {n_bytes} bytes; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})")
    return bnd


def bwd_bound(binned, work, tiles_x, tiles_y, tile):
    """The backward's bound: records read and gradients written once,
    the ranges, and grad, rgb and T read once per pixel."""
    pairs = binned.records.shape[1]
    pixels = tiles_x * tiles_y * tile * tile
    n_bytes = 2 * 9 * 4 * pairs + 2 * 4 * tiles_x * tiles_y + 7 * 4 * pixels
    evals, contribs = int(work["evals"]), int(work["contribs"])
    bnd = bound(n_bytes, OPS_PER_EVAL_BWD * evals
                + OPS_PER_CONTRIB_BWD * contribs + OPS_PER_RECORD_BWD * pairs)
    print(f"{tile} px blend backward work: {pairs} pairs, {evals} pixel "
          f"evaluations, {contribs} contributions, {n_bytes} bytes; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})")
    return bnd
