"""Syncs a frame: the CUDA runtime calls that wait for the device
(`spans.SYNC_CALL`) and start inside the program's `render` spans, over
the traced window's frames.  The loop's 8-bit copy lies outside."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "render") if w.kind == "render" else None
    return t.syncs / w.units if t and w.units else None
