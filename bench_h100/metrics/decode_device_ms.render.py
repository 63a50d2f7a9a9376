"""Device ms a frame of the operations inside the program's `decode`
ranges (the tri-plane features and the MLP heads that turn anchors into
gaussians)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or not w.units:
        return None
    busy, _, n = T.in_ranges_ns(w, "decode")
    return busy / 1e6 / w.units if n else None
