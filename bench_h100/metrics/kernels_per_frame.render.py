"""Device operations (kernels, memcpys, memsets) a frame launches, over the
traced window's frames: the host's dispatch load."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or not w.units or not w.ops:
        return None
    return len(w.ops) / w.units
