"""Host ms a frame that the program dispatches in: the host time of its
`render` spans, less the syncs inside them, over the traced window's
frames."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "render") if w.kind == "render" else None
    return (t.span_ns - t.sync_ns) / 1e6 / w.units if t and w.units else None
