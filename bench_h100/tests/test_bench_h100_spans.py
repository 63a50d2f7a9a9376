"""The readers of the program's spans (harness/spans.py and its nine
metrics) on hand-made traced windows: spans nested and on two threads,
syncs inside and outside the program's spans, an idle stretch that
half-overlaps `decode`, a step longer than `trace.breakdown`'s
200-event look-back, and the windows they find nothing in; the decode's
device time through a replayed CUDA graph, matched to its launch by
correlation id, and every other reader unchanged by the ids.

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


# ---------------------------------------------------------------------
# the decode replayed as a CUDA graph: its kernels lie in no device-side
# range and carry the correlation id of their cudaGraphLaunch
# ---------------------------------------------------------------------

def graph_window(units=1):
    """One frame, 0-20,000 ns: an eager decode (a device-side `decode`
    range, 1,000-3,000, holding two kernels), a replayed one (`decode`
    5,000-9,000 on the host, `decode_graph` inside it, its launch, id 7,
    at 6,000), a graph launched outside `decode_graph` (id 8) and the
    kernels of an ordinary launch (id 9)."""
    host = [(WINDOW_RANGE, 0, 20_000), ("render", 0, 19_000),
            ("decode", 500, 3_500), ("cudaLaunchKernel", 600, 700),
            ("decode", 5_000, 9_000), ("decode_graph", 5_500, 8_500),
            ("cudaGraphLaunch", 6_000, 6_400),
            ("cudaGraphLaunch_v10000", 12_000, 12_300),
            ("cudaLaunchKernel", 14_000, 14_100)]
    host_corr = [0, 0, 0, 3, 0, 0, 7, 8, 9]
    ops = [("dec_a", 1_000, 1_800), ("dec_b", 2_000, 3_000),
           ("graph_a", 6_500, 7_500), ("graph_b", 7_400, 8_000),
           ("Memset (Device)", 8_000, 8_100),
           ("other_graph", 12_500, 13_000), ("k", 14_200, 15_000)]
    op_corr = [3, 3, 7, 7, 7, 8, 9]
    ranges = [("decode", 1_000, 3_000)]
    w = _window("render", ops, ranges, host, units=units, window_s=2e-5)
    w.op_corr, w.host_corr = op_corr, host_corr
    return w


def test_graph_ops_are_matched_by_correlation_id():
    w = graph_window()
    assert T.graph_ops(w, "decode_graph") == [2, 3, 4]
    assert T.ops_in_ranges(w, "decode") == [0, 1]
    # the graph's kernels overlap: their union, 1,600 ns
    assert T.ops_ns(w, T.graph_ops(w, "decode_graph")) == 1_600


def test_decode_reader_counts_eager_and_replayed_decodes():
    w = graph_window(units=2)
    assert _read("decode_device_ms.render", w) == pytest.approx(
        (1_800 + 1_600) / 2 * MS)


@pytest.mark.parametrize("what", ["no_span", "other_launch", "no_ids"])
def test_decode_reader_leaves_out_other_launches(what):
    """A graph launched outside a `decode_graph` span, the operations of
    other launches and a trace without ids add nothing."""
    w = graph_window()
    eager = 1_800 * MS
    if what == "no_span":
        k = [h[0] for h in w.host].index("decode_graph")
        del w.host[k], w.host_corr[k]
    elif what == "other_launch":
        # the replay's launch now carries another id than its kernels
        w.host_corr = [70 if c == 7 else c for c in w.host_corr]
    else:
        w.op_corr, w.host_corr = [], []
    assert T.graph_ops(w, "decode_graph") == []
    assert _read("decode_device_ms.render", w) == pytest.approx(eager)


def test_decode_reader_counts_a_replay_alone():
    """A window of replays only (no device-side `decode` range), as the
    program renders since its decode became a graph."""
    w = graph_window()
    w.ranges = []
    assert _read("decode_device_ms.render", w) == pytest.approx(1_600 * MS)


def test_an_operation_in_both_counts_once():
    w = graph_window()
    w.ranges.append(("decode", 6_000, 8_200))  # covers the graph's kernels
    assert sorted(T.ops_in_ranges(w, "decode")) == [0, 1, 2, 3, 4]
    assert _read("decode_device_ms.render", w) == pytest.approx(
        (1_800 + 1_600) * MS)


class _Event:
    def __init__(self, name, start, end, device, corr, annotation=False):
        self._v = (name, start, end, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Profile:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_profile_events_keep_correlation_ids():
    """Each device operation and host event keeps its id, in its list's
    order; the window's events are those that start inside its range."""
    from bench_h100.harness.cell import window_events
    events = [_Event("aten::mm", 10, 20, "DeviceType.CPU", 101),
              _Event(WINDOW_RANGE, 15, 100, "DeviceType.CPU", 102),
              _Event("cudaGraphLaunch", 30, 35, "DeviceType.CPU", 7),
              _Event("k_early", 12, 14, "DeviceType.CUDA", 5),
              _Event("decode", 40, 60, "DeviceType.CUDA", 0, True),
              _Event("k", 40, 50, "DeviceType.CUDA", 7),
              _Event("k2", 50, 60, "DeviceType.CUDA", 7)]
    ev = T.profile_events(_Profile(events))
    assert [o[0] for o in ev.ops] == ["k_early", "k", "k2"]
    assert ev.op_corr == [5, 7, 7]
    assert ev.host_corr == [101, 102, 7]
    assert ev.ranges == [("decode", 40, 60)]
    got = window_events(_Profile(events))
    assert got["ops"] == [("k", 40, 50), ("k2", 50, 60)]
    assert got["op_corr"] == [7, 7]
    assert [h[0] for h in got["host"]] == [WINDOW_RANGE, "cudaGraphLaunch"]
    assert got["host_corr"] == [102, 7]
    assert got["window_s"] == pytest.approx(85e-9)
    w = T.Window(**got, units=1, unit_views=[[0]], stages={},
                 kind="render")
    assert T.graph_ops(w, WINDOW_RANGE) == [0, 1]


# ---------------------------------------------------------------------
# every other reader reads what it read before the ids were kept
# ---------------------------------------------------------------------

WORK = {"pairs": 1000, "tiles": 10, "pixels": 10240, "passed": 50_000,
        "contribs": 40_000, "evals": 90_000, "visible_anchors": 100,
        "gaussians": 700, "image_pixels": 9000}
COUNTS = {"per_camera": [WORK, dict(WORK, passed=60_000, pairs=1200)],
          "model": {"feat_dim": 32, "n_offsets": 10, "num_channels": 15},
          "anchors": 256, "level": 0, "params": 1000}


def fixed_windows(kind):
    """A traced window of two units, 0-100,000 ns, holding every span,
    range and kernel a reader looks for, with the ids a replayed decode
    gives; and the untraced window of a measured run."""
    unit = "train_step" if kind == "train" else "render"
    host = [(WINDOW_RANGE, 0, 100_000), (unit, 0, 45_000),
            (unit, 50_000, 95_000), ("decode", 2_000, 12_000),
            ("decode_graph", 4_000, 10_000), ("cudaGraphLaunch", 5_000, 6_000),
            ("decode", 52_000, 60_000), ("plane_sample", 53_000, 55_000),
            ("projection", 14_000, 18_000), ("cudaLaunchKernel", 15_000, 15_500),
            ("binning", 20_000, 30_000), (SYNC, 25_000, 27_000),
            ("optimizer", 35_000, 44_000), ("ssim", 62_000, 70_000),
            ("aten::add", 70_500, 71_500), (SYNC, 96_000, 97_000)]
    host_corr = [0, 0, 0, 0, 0, 7, 0, 0, 0, 8, 0, 21, 0, 0, 0, 22]
    ops = [("graph_k", 6_500, 8_000), ("graph_k2", 8_000, 9_500),
           ("proj", 15_200, 16_000), ("bin", 21_000, 24_000),
           ("bin2", 27_500, 29_000),
           ("void raster_tile::fwd_kernel<16, 256, 3, 0>(float const*)",
            30_000, 33_000),
           ("adam", 36_000, 40_000), ("dec", 53_000, 56_000),
           ("ssim_k", 63_000, 68_000),
           ("void raster_tile::bwd_kernel<16, 64, 3>(float*)",
            72_000, 80_000), ("Memcpy DtoH", 96_500, 97_000)]
    op_corr = [7, 7, 8, 11, 12, 13, 14, 15, 16, 17, 18]
    ranges = [("decode", 52_500, 57_000), ("plane_sample", 53_000, 56_000),
              ("projection", 15_000, 16_500), ("binning", 20_500, 29_500),
              ("optimizer", 35_500, 41_000), ("ssim", 62_500, 69_000)]
    views = [[0, 1], [1, 0]] if kind == "train" else [[0], [1]]
    latency = [float(i) + 0.25 for i in range(1, 41)]
    traced = T.Window(ops, ranges, host, 1e-4, 2, views,
                      {"backward": [10.0, 20.0], "adam": [4.0, 6.0]},
                      counts=COUNTS, kind=kind, latency_ms=latency,
                      op_corr=op_corr, host_corr=host_corr)
    measured = T.Window([], [], [], 2.5, 40, views * 20, {}, kind=kind,
                        latency_ms=latency, setup_s=12.5,
                        peak_bytes=3 * 2 ** 30 + 12345)
    return traced, measured


# each reader's readings of fixed_windows("train") and ("render"),
# traced and measured, by the readers as they were before the ids
BEFORE = {
    'adam_ms.train': [5.0, None, None, None],
    'backward_ms.train': [15.0, None, None, None],
    'binning_device_ms.render': [None, None, 0.00225, None],
    'binning_span_ms.render': [None, None, 0.0045, None],
    'blend_bwd_roofline.train': [5.46268656716418, None, None, None],
    'blend_fwd_roofline.render': [None, None, 4.050149253731343, None],
    'decode_graph_share.render': [None, None, 50.0, None],
    'decode_idle_ms.render': [None, None, 0.006, None],
    'device_idle_share.render': [None, None, 68.19999999999999, None],
    'device_idle_share.train': [68.19999999999999, None, None, None],
    'dispatch_ms.render': [None, None, 0.044, None],
    'dispatch_ms.train': [0.044, None, None, None],
    'frame_mfu.render': [None, None, 0.14257313432835822, None],
    'host_syncs_per_frame.render': [None, None, 0.5, None],
    'host_syncs_per_step.train': [0.5, None, None, None],
    'kernels_per_frame.render': [None, None, 5.5, None],
    'kernels_per_step.train': [5.5, None, None, None],
    'optimizer_device_ms.train': [0.002, None, None, None],
    'plane_sample_device_ms.train': [0.0015, None, None, None],
    'projection_device_ms.render': [None, None, 0.0004, None],
    'render_frame_ms': [None, None, None, 62.5],
    'render_frame_p95_ms.host': [None, None, 39.2, 39.2],
    'setup_s': [None, 12.5, None, 12.5],
    'ssim_device_ms.train': [0.0025, None, None, None],
    'step_mfu.train': [1.6434328358208956, None, None, None],
    'sync_wait_ms.render': [None, None, 0.001, None],
    'sync_wait_ms.train': [0.001, None, None, None],
    'train_peak_mem_gib': [None, 3.0000114971771836, None, None],
    'train_step_ms': [None, 62.5, None, None],
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_other_readers_read_as_before(name):
    got = [_read(name, w) for kind in ("train", "render")
           for w in fixed_windows(kind)]
    assert got == BEFORE[name]
