"""Device ms a step of the kernels inside the program's `ssim` ranges
(forward and backward of every view's SSIM)."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "train" or not w.units:
        return None
    busy, _, n = T.in_ranges_ns(w, "ssim")
    return busy / 1e6 / w.units if n else None
