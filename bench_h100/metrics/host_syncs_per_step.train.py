"""Syncs a step: the CUDA runtime calls that wait for the device
(`spans.SYNC_CALL`) and start inside the program's `train_step` spans,
over the traced window's steps.  The loop's own copies lie outside."""
from bench_h100.harness import spans as S


def read(w):
    t = S.host_time(w, "train_step") if w.kind == "train" else None
    return t.syncs / w.units if t and w.units else None
