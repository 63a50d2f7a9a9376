"""The device's idle share of the traced render window: 1 - the union of
its kernels, memcpys and memsets over the window's wall span, in %."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or w.window_s <= 0 or not w.ops:
        return None
    return 100.0 * (1.0 - T.busy_ns(w) / 1e9 / w.window_s)
