"""Host ms a frame spent waiting in syncs (`spans.SYNC_CALL`) inside the
program's `render` spans, over the traced window's frames."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "render") if w.kind == "render" else None
    return t.sync_ns / 1e6 / w.units if t and w.units else None
