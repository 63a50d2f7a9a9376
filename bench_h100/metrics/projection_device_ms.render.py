"""Device ms a frame of the kernels inside the program's `projection`
ranges (the anchor prefilter and the EWA projection)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or not w.units:
        return None
    busy, _, n = T.in_ranges_ns(w, "projection")
    return busy / 1e6 / w.units if n else None
