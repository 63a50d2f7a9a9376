"""Device ms a step of the kernels inside the program's `plane_sample`
ranges (the tri-plane sampler, forward and backward)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "train" or not w.units:
        return None
    busy, _, n = T.in_ranges_ns(w, "plane_sample")
    return busy / 1e6 / w.units if n else None
