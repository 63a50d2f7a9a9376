"""Device-idle ms a frame while the host is in the program's `decode`
spans (their child spans included): the window's stretches with no
device operation that overlap them, over the traced window's frames."""
from bench_h100.harness import spans as S


def read(w):
    if w.kind != "render" or not w.units or not w.ops:
        return None
    decode = S.host_spans(w, "decode")
    if not decode:
        return None
    return S.length(S.intersect(S.idle_gaps(w), decode)) / 1e6 / w.units
