"""Device-side span a frame of the program's `binning` ranges: their work
and the gaps inside them (the read-back of the pair count)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or not w.units:
        return None
    _, span, n = T.in_ranges_ns(w, "binning")
    return span / 1e6 / w.units if n else None
