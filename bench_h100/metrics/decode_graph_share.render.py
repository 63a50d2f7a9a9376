"""Share of the traced window's decodes that the program replayed as one
CUDA graph, in %: the merged `decode` host spans that hold a
`decode_graph` span (the replay).  0 where the program replays none."""
import bisect

from bench_h100.harness import spans as S


def read(w):
    if w.kind != "render" or not w.units:
        return None
    decode = S.host_spans(w, "decode")
    if not decode:
        return None
    starts = [s for s, _ in decode]
    held = {bisect.bisect_right(starts, s) - 1
            for s, _ in S.intersect(decode, S.host_spans(w, "decode_graph"))}
    return 100.0 * len(held) / len(decode)
