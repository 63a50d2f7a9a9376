"""The readers of the program's spans (harness/spans.py and its nine
metrics) on hand-made traced windows: spans nested and on two threads,
syncs inside and outside the program's spans, an idle stretch that
half-overlaps `decode`, a step longer than `trace.breakdown`'s
200-event look-back, and the windows they find nothing in.

    python -m pytest bench_h100/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.harness import spans as S  # noqa: E402
from bench_h100.harness import spec  # noqa: E402
from bench_h100.harness import trace as T  # noqa: E402
from bench_h100.harness.cell import WINDOW_RANGE  # noqa: E402

MS = 1e-6  # ms a ns
SYNC = "cudaStreamSynchronize"
TRAIN = ("dispatch_ms.train", "host_syncs_per_step.train",
         "sync_wait_ms.train", "optimizer_device_ms.train")
RENDER = ("dispatch_ms.render", "host_syncs_per_frame.render",
          "sync_wait_ms.render", "decode_device_ms.render",
          "decode_idle_ms.render")


def _window(kind, ops=(), ranges=(), host=(), units=1, window_s=1e-5):
    return T.Window(list(ops), list(ranges), list(host), window_s, units,
                    [[0]] * units, {}, kind=kind)


def _read(name, w):
    return spec.reader(name)(w)


def train_window():
    """Two steps: the first 0-10,000 ns, its backward's operators on a
    second thread; the second 12,000-20,000 ns.  A sync in each step,
    one in the loop between them."""
    host = [(WINDOW_RANGE, 0, 20_000),
            ("train_step", 0, 10_000), ("train_step", 12_000, 20_000),
            ("aten::mul", 1_000, 1_900), (SYNC, 2_000, 2_500),
            ("backward_op", 4_000, 11_000),  # the other thread
            ("optimizer", 8_000, 9_500), ("cudaLaunchKernel", 8_100, 8_200),
            (SYNC, 10_500, 11_500),  # the loop's, between the steps
            ("cudaEventSynchronize_v3020", 15_000, 16_000)]
    ops = [("k", 2_000, 2_600), ("adam", 8_200, 8_600),
           ("adam", 9_000, 9_100), ("k", 15_000, 16_000)]
    ranges = [("optimizer", 8_150, 9_200)]
    return _window("train", ops, ranges, host, units=2, window_s=2e-5)


def test_train_readers():
    w = train_window()
    assert S.host_time(w, "train_step") == (18_000, 2, 1_500)
    assert _read("dispatch_ms.train", w) == pytest.approx(16_500 / 2 * MS)
    assert _read("host_syncs_per_step.train", w) == 1.0
    assert _read("sync_wait_ms.train", w) == pytest.approx(1_500 / 2 * MS)
    assert _read("optimizer_device_ms.train", w) == pytest.approx(500 / 2
                                                                  * MS)


def render_window(units=1):
    """One frame, 0-9,000 ns of a 10,000 ns window: `decode` 1,500-4,000
    (a second thread's 2,500-4,500 overlaps it), `plane_sample` inside
    it, and the device idle at 1,000-2,000, 3,000-6,000 and
    9,500-10,000."""
    host = [(WINDOW_RANGE, 0, 10_000), ("render", 0, 9_000),
            ("decode", 1_500, 4_000), ("decode", 2_500, 4_500),
            ("plane_sample", 3_500, 4_000), (SYNC, 6_500, 7_000),
            (SYNC, 9_200, 9_400)]  # the loop's 8-bit copy
    ops = [("k", 0, 1_000), ("k", 2_000, 3_000), ("k", 6_000, 9_500)]
    ranges = [("decode", 1_500, 3_200)]
    return _window("render", ops, ranges, host, units=units)


def test_render_readers():
    w = render_window(units=2)
    assert S.host_spans(w, "decode") == [(1_500, 4_500)]
    assert S.idle_gaps(w) == [(1_000, 2_000), (3_000, 6_000),
                              (9_500, 10_000)]
    assert _read("dispatch_ms.render", w) == pytest.approx(8_500 / 2 * MS)
    assert _read("host_syncs_per_frame.render", w) == 0.5
    assert _read("sync_wait_ms.render", w) == pytest.approx(500 / 2 * MS)
    assert _read("decode_device_ms.render", w) == pytest.approx(1_000 / 2
                                                                * MS)
    # 500 of the first stretch, 1,500 of the second
    assert _read("decode_idle_ms.render", w) == pytest.approx(2_000 / 2
                                                              * MS)


def test_idle_by_innermost_span():
    w = render_window()
    got = S.idle_by_span(w)
    assert got == {"render": 500 + 1_500, "decode": 500 + 1_000,
                   "plane_sample": 500, S.NO_SPAN: 500}
    assert sum(got.values()) == w.window_s * 1e9 - T.busy_ns(w)


def test_a_step_longer_than_the_look_back():
    """A gap 300 host events into a step: `breakdown` finds no host
    operation open there, the spans' arithmetic finds the step."""
    host = [(WINDOW_RANGE, 0, 100_000), ("train_step", 0, 100_000)]
    host += [("aten::add", 10 * i, 10 * i + 5) for i in range(300)]
    ops = [("k", 0, 3_000), ("k", 4_000, 100_000)]
    w = _window("train", ops, host=host, window_s=1e-4)
    assert T.breakdown(w)["idle_gaps"][0][0] == "(no host operation)"
    assert S.idle_by_span(w) == {"train_step": 1_000}
    assert _read("dispatch_ms.train", w) == pytest.approx(100_000 * MS)


@pytest.mark.parametrize("name, matches", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaStreamSynchronize_v3020", True),
    ("cudaLaunchKernel", False), ("cudaStreamWaitEvent", False),
    ("cudaMemcpyAsync", False), ("cudaStreamSynchronizeX", False),
])
def test_sync_calls_by_name(name, matches):
    assert bool(S.SYNC_CALL.match(name)) is matches


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_nothing_to_read(name):
    """None for the other cell's kind, for a window without the
    program's spans (a program without them), and for no units."""
    right, other = ((train_window, render_window) if name in TRAIN
                    else (render_window, train_window))
    assert _read(name, other()) is None
    bare = right()
    bare.host = [h for h in bare.host if h[0] not in S.PROGRAM_SPANS]
    bare.ranges = []
    assert _read(name, bare) is None
    empty = right()
    empty.units = 0
    assert _read(name, empty) is None
