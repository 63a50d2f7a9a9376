"""The viewer's tail: the 95th percentile of one frame's time from its
request to its 8-bit image in host memory, in ms, over the untraced
stretch that a traced render run measures before its trace
(drivers/render.py).  A per-layer metric because the card idles most of
a frame: the tail is the host's (its launches and the copy's wait), and
swings with it."""
import statistics


def read(w):
    if w.kind != "render" or len(w.latency_ms) < 20:
        return None
    return statistics.quantiles(w.latency_ms, n=20)[-1]
