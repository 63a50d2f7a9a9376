"""Device ms a frame of the decode (the tri-plane features and the MLP
heads that turn anchors into gaussians): the operations inside the
program's `decode` device-side ranges (an eager decode), and those that
a `cudaGraphLaunch` inside a `decode_graph` host span launched (a
replayed decode, whose kernels lie in no range), matched to the launch
by correlation id; an operation both find counts once."""
from bench_h100.harness import trace as T


def read(w):
    if w.kind != "render" or not w.units:
        return None
    found = set(T.ops_in_ranges(w, "decode")) | set(
        T.graph_ops(w, "decode_graph"))
    return T.ops_ns(w, found) / 1e6 / w.units if found else None
