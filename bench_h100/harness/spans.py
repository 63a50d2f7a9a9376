"""The program's own spans in a traced window, against the host's syncs
and the device's idle time.

splatco_torch opens `torch.profiler.record_function` spans around its
layers: `train_step`, `render`, `decode` and `optimizer` around the step,
the frame, the decode and Adam, and `projection`, `plane_sample`,
`binning`, `slot_reduce` and `ssim` inside them.  Each is a host event
(`Window.host`) and, where it holds device work, a device-side range
(`Window.ranges`, read by `trace.in_ranges_ns`).  Here they are read on
the host: a name's spans are merged across threads (autograd runs the
backward's operators on a thread of its own) into disjoint pieces, and
laid over other interval sets.  Nothing looks back a fixed number of
events, so a span as long as a step is found whatever it holds.

A sync is a CUDA runtime call that blocks the host until the device has
caught up (`SYNC_CALL`): PyTorch's blocking copies and read-backs end in
`cudaStreamSynchronize`.  The device does not idle during one; it idles
after it, while the host refills an empty queue."""
from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from bench_h100.harness.cell import WINDOW_RANGE
from bench_h100.harness.trace import Window, merged

Pieces = List[Tuple[int, int]]  # disjoint [start, end) ns, in order

# the runtime calls that wait for the device, under the names a card's
# trace gives them (a versioned entry point adds a `_v<n>` suffix)
SYNC_CALL = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize"
                       r"|cudaEventSynchronize)(_v\d+)?$")
PROGRAM_SPANS = ("train_step", "render", "decode", "optimizer",
                 "projection", "plane_sample", "binning", "slot_reduce",
                 "ssim")
NO_SPAN = "none"


def host_spans(w: Window, name: str) -> Pieces:
    """The host spans named `name`, merged across threads."""
    return merged((s, e) for n, s, e in w.host if n == name)


def length(pieces: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in pieces)


def intersect(a: Pieces, b: Pieces) -> Pieces:
    """The overlap of two sets of disjoint pieces, each in order."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def bounds(w: Window) -> Tuple[int, int]:
    """The window's start and end, from its own host range."""
    return next((s, e) for n, s, e in w.host if n == WINDOW_RANGE)


def idle_gaps(w: Window) -> Pieces:
    """The stretches of the window in which the device runs no
    operation."""
    start, end = bounds(w)
    out, t = [], start
    for s, e in merged((s, e) for _, s, e in w.ops):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out


def sync_calls(w: Window) -> List[Tuple[int, int]]:
    return sorted((s, e) for n, s, e in w.host if SYNC_CALL.match(n))


class HostTime(NamedTuple):
    span_ns: int   # the spans' merged host time
    syncs: int     # sync calls that start inside them
    sync_ns: int   # the host time of those calls inside the spans


def host_time(w: Window, name: str) -> Optional[HostTime]:
    """The host time of the `name` spans and of the syncs inside them;
    None where the window has no such span."""
    spans = host_spans(w, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    calls = []
    for s, e in sync_calls(w):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][1]:
            calls.append((s, e))
    sync_ns = length(intersect(merged(calls), spans))
    return HostTime(length(spans), len(calls), sync_ns)


def idle_by_span(w: Window) -> Dict[str, int]:
    """The window's device-idle ns, split by the innermost program span
    (`PROGRAM_SPANS`) the host was in, the open one that started last;
    `NO_SPAN` where it was in none."""
    spans = [(s, e, n) for n, s, e in w.host
             if n in PROGRAM_SPANS and e > s]
    marks = sorted([(e, 0, k) for k, (_, e, _) in enumerate(spans)]
                   + [(s, 1, k) for k, (s, _, _) in enumerate(spans)])
    open_: Dict[int, Tuple[int, int, str]] = {}
    stretches: Dict[str, Pieces] = {}

    def innermost() -> str:
        if not open_:
            return NO_SPAN
        return max(open_.values(), key=lambda x: (x[0], -x[1]))[2]

    start, end = bounds(w)
    t = start
    for time_, opens, k in marks:
        if time_ > t:
            stretches.setdefault(innermost(), []).append((t, time_))
            t = time_
        if opens:
            open_[k] = spans[k]
        else:
            del open_[k]
    stretches.setdefault(NO_SPAN, []).append((t, end))
    gaps = idle_gaps(w)
    out = {n: length(intersect(p, gaps)) for n, p in stretches.items()}
    return {n: ns for n, ns in out.items() if ns}
