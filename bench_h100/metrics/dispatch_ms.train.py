"""Host ms a step that the program dispatches in: the host time of its
`train_step` spans, less the syncs inside them, over the traced window's
steps."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "train_step") if w.kind == "train" else None
    return (t.span_ns - t.sync_ns) / 1e6 / w.units if t and w.units else None
