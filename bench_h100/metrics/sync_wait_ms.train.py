"""Host ms a step spent waiting in syncs (`spans.SYNC_CALL`) inside the
program's `train_step` spans, over the traced window's steps."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "train_step") if w.kind == "train" else None
    return t.sync_ns / 1e6 / w.units if t and w.units else None
