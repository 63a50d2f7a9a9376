"""The whole SVC step's share of the card's fp32 peak over the traced
window, in %: the operations counts/flops.py counts for the window's
steps (their views' counts), over the window's wall time at 67 TFLOP/s."""
from bench_h100.counts.bounds import PEAK_FP32_PER_S
from bench_h100.counts.flops import step_ops


def read(w):
    if w.kind != "train" or not w.counts or w.window_s <= 0:
        return None
    c = w.counts
    cams = c["per_camera"]
    ops = sum(step_ops(c["model"], c["anchors"], c["level"],
                       [cams[v] for v in views], c["params"])
              for views in w.unit_views)
    return 100.0 * ops / (w.window_s * PEAK_FP32_PER_S)
