"""Device ms a step of the operations inside the program's `optimizer`
ranges (the multi-group Adam's update)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "train" or not w.units:
        return None
    busy, _, n = T.in_ranges_ns(w, "optimizer")
    return busy / 1e6 / w.units if n else None
