"""The traced window: torch.profiler over the window, its events reduced
to plain intervals, and the arithmetic the metric readers share.

Times are nanoseconds on the profiler's clock, which the host's and the
device's events share.  A device operation is a kernel, memcpy or memset
(`ops`); a device-side range is the span a `record_function` range's
work covers on the device (`ranges`); host operations are the CPU-side
operators, ranges and CUDA runtime calls (`host`).  Each device operation
and host event keeps its correlation id (`op_corr`, `host_corr`, lists
parallel to `ops` and `host`): a runtime call and the operations it
launched share one, the kernels of a replayed CUDA graph that of its
`cudaGraphLaunch`."""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@dataclasses.dataclass
class Window:
    """What a metric reader reads: the window, with --trace 1 its events,
    and the work counted on the cell's inputs.  Without a trace the
    events are empty and `window_s` is the measured window's wall
    time."""
    ops: List[Interval]
    ranges: List[Interval]
    host: List[Interval]
    window_s: float
    units: int                # steps or frames completed in the window
    unit_views: List[List[int]]  # the cameras of each step or frame
    stages: Dict[str, List[float]]  # phase -> ms of each unit
    counts: Optional[Dict] = None  # harness/counting.py's, per camera
    kind: str = ""            # the driver's name: "train", "render"
    # each request's time to its answer, in ms, from an untraced window
    latency_ms: List[float] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0      # process start to the window's start
    peak_bytes: int = 0       # the device allocator's peak in the window
    # the correlation id of each of `ops` and of `host`, in their order
    op_corr: List[int] = dataclasses.field(default_factory=list)
    host_corr: List[int] = dataclasses.field(default_factory=list)


class Events(NamedTuple):
    """The events of a trace, each list in the profiler's order."""
    ops: List[Interval]
    ranges: List[Interval]
    host: List[Interval]
    op_corr: List[int]
    host_corr: List[int]


# a CUDA graph's launch, under the name a card's trace gives it (a
# versioned entry point adds a `_v<n>` suffix)
GRAPH_LAUNCH = re.compile(r"^cudaGraphLaunch(_v\d+)?$")


def profile_events(prof) -> Events:
    """The device ops, device-side ranges and host events of a finished
    torch.profiler.profile, with the ops' and host events' correlation
    ids."""
    ev = Events([], [], [], [], [])
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.end_ns())
        if not str(e.device_type()).endswith("CUDA"):
            ev.host.append(item)
            ev.host_corr.append(e.correlation_id())
        elif e.is_user_annotation():
            ev.ranges.append(item)
        else:
            ev.ops.append(item)
            ev.op_corr.append(e.correlation_id())
    return ev


def gaps(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The idle stretches between the union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def busy_ns(w: Window) -> int:
    return union_ns((s, e) for _, s, e in w.ops)


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union's disjoint pieces, in order."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def ops_in_ranges(w: Window, name: str) -> List[int]:
    """The indices of the ops that lie inside a `name` device-side
    range."""
    pieces = merged((s, e) for n, s, e in w.ranges if n == name)
    starts = [p[0] for p in pieces]
    inside = []
    for k, (_, s, e) in enumerate(w.ops):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= pieces[i][1]:
            inside.append(k)
    return inside


def in_ranges_ns(w: Window, name: str) -> Tuple[int, int, int]:
    """(device time of the ops inside the `name` ranges, the ranges'
    span, the ops inside them)."""
    pieces = merged((s, e) for n, s, e in w.ranges if n == name)
    inside = ops_in_ranges(w, name)
    return (ops_ns(w, inside), sum(e - s for s, e in pieces), len(inside))


def ops_ns(w: Window, which: Iterable[int]) -> int:
    """The device time of the ops with these indices (their union)."""
    return union_ns((w.ops[k][1], w.ops[k][2]) for k in which)


def graph_ops(w: Window, span: str) -> List[int]:
    """The indices of the ops that a `cudaGraphLaunch` started inside a
    `span` host span launched: those that share its correlation id."""
    spans = merged((s, e) for n, s, e in w.host if n == span)
    starts = [s for s, _ in spans]
    launches = set()
    for (n, s, _), corr in zip(w.host, w.host_corr):
        i = bisect.bisect_right(starts, s) - 1
        if GRAPH_LAUNCH.match(n) and i >= 0 and s < spans[i][1]:
            launches.add(corr)
    return [k for k, corr in enumerate(w.op_corr) if corr in launches]


def kernel_ns(w: Window, pattern: str) -> Tuple[int, int]:
    """(device time, launches) of the kernels whose name matches the
    regular expression `pattern`."""
    rx = re.compile(pattern)
    hits = [(s, e) for n, s, e in w.ops if rx.search(n)]
    return sum(e - s for s, e in hits), len(hits)


def breakdown(w: Window, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was running in their middle (the innermost
    host operation open then)."""
    by_op: Dict[str, int] = {}
    for n, s, e in w.ops:
        n = n or "(unnamed)"
        by_op[n] = by_op.get(n, 0) + (e - s)
    host = sorted(w.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host: Dict[str, int] = {}
    for s, e in gaps((s, e) for _, s, e in w.ops):
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        name = "(no host operation)"
        for j in range(i - 1, max(-1, i - 200), -1):
            if host[j][2] >= mid:
                name = host[j][0] or "(unnamed)"
                break
        by_host[name] = by_host.get(name, 0) + (e - s)

    def top_of(d):
        return [[n, v / 1e9] for n, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}
