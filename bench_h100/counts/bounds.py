"""Peaks of one H100 SXM and the least time a kernel's work can take.

Frozen from splatco_torch/utils/measure.py, corrected: the blend's
exponentials are counted on the special-function unit at its rate (16
results a clock an SM), not as one fp32 operation each.  A bound counts
each input byte read once and each output byte written once, and only
the operations that the inputs need: the pixel evaluations that pass
the alpha test (any other can be rejected without an exponential) and
the contributions, as harness/counting.py counts them on the reference.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA's data sheet, H100 SXM: HBM3 rate; fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# MUFU (ex2, rcp, rsqrt, ...): 16 a clock an SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput), 132
# SMs at the maximum SM clock, 1,980 MHz
SM_COUNT = 132
SFU_PER_CLOCK_SM = 16
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_SFU_PER_S = SM_COUNT * SFU_PER_CLOCK_SM * MAX_SM_CLOCK_HZ

# fp32 operations of a pixel evaluation that passes the alpha test: dx,
# dy, the quadratic form (8), alpha = op * exp, the clamp, two compares;
# its exponential is on the SFU
OPS_PER_PASS = 15
# a contribution: 1 - alpha, T (1 - alpha), the compare, w, three colour
# multiply-adds
OPS_PER_CONTRIB = 10
# the backward: each passing evaluation replayed; per contribution the
# weights, dalpha, dpower, six moment and three colour terms and the nine
# running sums; per record its nine gradients from the sums
OPS_PER_PASS_BWD = 15
OPS_PER_CONTRIB_BWD = 35
OPS_PER_RECORD_BWD = 12
# a record: nine float32 columns
RECORD_BYTES = 36


def bound_s(n_bytes: float, n_ops: float, n_sfu: float = 0.0) -> float:
    """The least seconds: the largest of bytes at the memory rate, fp32
    operations at their peak, SFU results at theirs."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S,
               n_sfu / PEAK_SFU_PER_S)


def blend_fwd_bound_s(w: Dict) -> float:
    """One frame's forward blend: records read once, each tile's range
    (8 B), and rgb and T (16 B) written once a padded pixel."""
    n_bytes = (RECORD_BYTES * w["pairs"] + 8 * w["tiles"]
               + 16 * w["pixels"])
    return bound_s(n_bytes, OPS_PER_PASS * w["passed"]
                   + OPS_PER_CONTRIB * w["contribs"], w["passed"])


def blend_bwd_bound_s(w: Dict) -> float:
    """One view's backward blend: records read and their gradients
    written once, the ranges, and the cotangent, rgb and T read once a
    padded pixel (28 B)."""
    n_bytes = (2 * RECORD_BYTES * w["pairs"] + 8 * w["tiles"]
               + 28 * w["pixels"])
    return bound_s(n_bytes, OPS_PER_PASS_BWD * w["passed"]
                   + OPS_PER_CONTRIB_BWD * w["contribs"]
                   + OPS_PER_RECORD_BWD * w["pairs"], w["passed"])
