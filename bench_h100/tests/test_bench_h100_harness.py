"""The harness on the CPU: cells found by name, BENCHMARK.json's form,
the metric readers' arithmetic on synthetic events, the counts, and the
modules a run loads.

    python -m pytest bench_h100/tests -q
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.counts import bounds as B  # noqa: E402
from bench_h100.counts import flops as F  # noqa: E402
from bench_h100.harness import spec  # noqa: E402
from bench_h100.harness import trace as T  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
# the configuration's widths and shapes, which no cut may change
WIDTHS = {"feat_dim", "n_offsets", "mlp_dim", "num_channels", "plane_size",
          "sh_degree", "appearance_dim", "width", "height", "tile", "kmax"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


STUB_DRIVER = """from bench_h100.harness import trace as T


def run(cfg, traffic, seed, seconds, trace, dev, t_start):
    w = T.Window([], [], [], 2.0, traffic["units"], [[0]], {},
                 kind="stub", setup_s=1.5)
    return {"window": w, "correct": True, "attempted": 1, "failed": 0,
            "checks": [], "peak": 0}
"""


def test_added_files_are_found_by_name(tmp_path, bench):
    """A config, a mix, a driver and metrics (end-to-end and per-layer)
    added as files, with entries added to a copy of BENCHMARK.json, are
    found and run; no existing file changes."""
    base = tmp_path / "bench_h100"
    for sub in ("configs", "traffic", "metrics", "drivers"):
        shutil.copytree(ROOT / "bench_h100" / sub, base / sub)
    before = _digest(base)
    cfg = json.loads((base / "configs" / "splatco-quickstart-v2.json")
                     .read_text())
    cfg["render"]["width"] = 800
    (base / "configs" / "added-config.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "orbit-render.json").read_text())
    mix["cameras"] = 16
    (base / "traffic" / "added-mix.json").write_text(json.dumps(mix))
    (base / "traffic" / "stub-mix.json").write_text(
        json.dumps({"driver": "stub", "units": 4}))
    (base / "drivers" / "stub.py").write_text(STUB_DRIVER)
    (base / "metrics" / "added_metric.render.py").write_text(
        "def read(w):\n    return 2.0 * w.units\n")
    (base / "metrics" / "stub_unit_ms.py").write_text(
        "def read(w):\n    return 1e3 * w.window_s / w.units\n")
    added = json.loads(json.dumps(bench))
    added["configs"].append({"name": "added-config", "source": "x",
                             "file": "bench_h100/configs/added-config.json",
                             "reduced": [], "why": "a test"})
    added["workloads"] += [{"name": "added-cell", "config": "added-config",
                            "traffic": "added-mix", "chips": 1,
                            "why": "a test"},
                           {"name": "stub-cell", "config": "added-config",
                            "traffic": "stub-mix", "chips": 1,
                            "why": "a test"}]
    added["per_layer"].append({"name": "added_metric.render", "unit": "x",
                               "better": "lower", "source": "device_trace",
                               "layer": "a", "moves": "render_frame_ms",
                               "workloads": ["added-cell"]})
    added["end_to_end"].append({"name": "stub_unit_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["stub-cell"]})
    w = spec.cell(added, "added-cell")
    assert spec.config(added, w["config"], tmp_path)["render"]["width"] == 800
    assert spec.traffic(w["traffic"], base)["cameras"] == 16
    win = T.Window([], [], [], 1.0, 3, [[0]] * 3, {}, kind="render")
    got = spec.read_metrics(added, "added-cell", "per_layer", win, base)
    assert got == {"added_metric.render": {"value": 6.0, "unit": "x"}}
    from bench_h100.harness import cell
    res = cell.execute(added, "stub-cell", 7, 1.0, False, None, 0.0,
                       base=base)
    assert res["metrics"] == {"stub_unit_ms": {"value": 500.0, "unit": "ms"},
                              "setup_s": {"value": 1.5, "unit": "s"}}
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before


def test_network_weights_do_not_follow_the_seed():
    """The seed moves the scene's anchors; the network (planes, heads,
    decoders, TPA) is the same for every seed, so is the work."""
    import torch

    from bench_h100.harness import inputs
    from bench_h100.reference.step import leaves
    cfg = json.loads((ROOT / "bench_h100" / "configs"
                      / "splatco-quickstart-v2.json").read_text())
    cfg["scene"]["anchors"] = 64
    cfg["model"]["plane_size"] = 64
    one, two = (leaves(inputs.make_params(cfg, s, torch.device("cpu")))
                for s in (2 ** 31 + 5, 6))
    assert set(one) == set(two)
    for key in one:
        same = torch.equal(one[key], two[key])
        if key.startswith("/anchors") and key not in ("/anchors/rotation",
                                                     "/anchors/opacity"):
            assert not same, key
        else:
            assert same, key


def test_benchmark_json_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) and k not in WIDTHS
                   and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    cells = {}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        mix = ROOT / "bench_h100" / "traffic" / f"{w['traffic']}.json"
        driver = json.loads(mix.read_text())["driver"]
        assert (ROOT / "bench_h100" / "drivers" / f"{driver}.py").is_file()
        cells[w["name"]] = w
    assert len(cells) == len(bench["workloads"])
    assert {w["config"] for w in cells.values()} == set(names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert (ROOT / "bench_h100" / "metrics" / f"{m['name']}.py").is_file()
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (ROOT / "bench_h100" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell_name in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", list(cells))
            assert cell_name in reports
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = bench["end_to_end"] + bench["per_layer"] + bench["configs"] \
        + bench["workloads"]
    for entry in every:
        for key in TEXT_KEYS:
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for name in cells:
        assert any(name in m.get("workloads", [name])
                   for m in bench["per_layer"])
        assert len(spec.metrics_of(bench, name, "end_to_end")) >= 2
    assert len(json.dumps(bench)) <= 64 * 1024
    budget = 2 + 14 * 24
    assert (budget * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def _window(ops, ranges=(), host=(), units=1, window_s=1.0, **kw):
    return T.Window(list(ops), list(ranges), list(host), window_s, units,
                    kw.pop("unit_views", [[0]] * units), kw.pop("stages", {}),
                    **kw)


def _read(name, w):
    return spec.reader(name)(w)


def test_idle_share_is_a_union_of_intervals():
    # two overlapping kernels and a memcpy: busy 0-300 and 500-600 ns
    ops = [("k1", 0, 200), ("k2", 100, 300), ("Memcpy", 500, 600)]
    w = _window(ops, window_s=1e-6, kind="train")
    assert T.busy_ns(w) == 400
    assert _read("device_idle_share.train", w) == pytest.approx(60.0)
    assert _read("device_idle_share.render", w) is None
    w.kind = "render"
    assert _read("device_idle_share.render", w) == pytest.approx(60.0)


def test_kernels_per_unit():
    ops = [(f"k{i}", 10 * i, 10 * i + 5) for i in range(12)]
    assert _read("kernels_per_step.train",
                 _window(ops, units=4, kind="train")) == 3.0
    assert _read("kernels_per_frame.render",
                 _window(ops, units=3, kind="render")) == 4.0
    assert _read("kernels_per_frame.render",
                 _window([], units=3, kind="render")) is None


def test_range_device_time_against_span():
    # a binning range 100-400 holding two kernels with a gap; a kernel
    # outside it
    ranges = [("binning", 100, 400), ("ssim", 500, 700)]
    ops = [("a", 100, 150), ("b", 300, 400), ("c", 450, 480),
           ("d", 500, 650)]
    w = _window(ops, ranges, units=2, kind="render")
    assert T.in_ranges_ns(w, "binning") == (150, 300, 2)
    assert _read("binning_device_ms.render", w) == pytest.approx(75e-6)
    assert _read("binning_span_ms.render", w) == pytest.approx(150e-6)
    assert _read("projection_device_ms.render", w) is None
    w.kind = "train"
    assert _read("ssim_device_ms.train", w) == pytest.approx(75e-6)


def test_stage_means_and_kernel_match():
    w = _window([], units=2, kind="train",
                stages={"backward": [10.0, 20.0], "adam": [4.0, 6.0]})
    assert _read("backward_ms.train", w) == 15.0
    assert _read("adam_ms.train", w) == 5.0
    ops = [("void raster_tile::fwd_kernel<32, 512, 3, 0>(float const*)", 0,
            10), ("void project_fwd_kernel(float const*)", 20, 40),
           ("void raster_tile::bwd_kernel<16, 64, 3>(float*)", 50, 70)]
    w = _window(ops)
    assert T.kernel_ns(w, r"(?<![A-Za-z0-9_])fwd_kernel\b") == (10, 1)
    assert T.kernel_ns(w, r"(?<![A-Za-z0-9_])bwd_kernel\b") == (20, 1)


def test_breakdown_names_the_host_op_in_each_gap():
    ops = [("k1", 0, 100), ("k2", 300, 400), ("k3", 1000, 1100)]
    host = [("aten::add", 90, 350), ("binning", 380, 1200),
            ("cudaStreamSynchronize", 420, 990)]
    out = T.breakdown(_window(ops, host=host))
    assert out["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert out["idle_gaps"][0][1] == pytest.approx(600e-9)
    assert out["idle_gaps"][1][0] == "aten::add"
    assert out["idle_gaps"][1][1] == pytest.approx(200e-9)
    assert out["device_ops"][0][1] == pytest.approx(100e-9)


def _work(**kw):
    w = {"pairs": 1000, "tiles": 10, "pixels": 10240, "passed": 50_000,
         "contribs": 40_000, "evals": 90_000, "visible_anchors": 100,
         "gaussians": 700, "image_pixels": 9000}
    w.update(kw)
    return w


def test_blend_bounds_at_a_small_size():
    w = _work()
    by_bytes = (36 * 1000 + 8 * 10 + 16 * 10240) / B.PEAK_BYTES_PER_S
    by_ops = (15 * 50_000 + 10 * 40_000) / B.PEAK_FP32_PER_S
    by_sfu = 50_000 / B.PEAK_SFU_PER_S
    assert B.blend_fwd_bound_s(w) == pytest.approx(max(by_bytes, by_ops,
                                                       by_sfu))
    bwd = B.blend_bwd_bound_s(w)
    assert bwd >= B.blend_fwd_bound_s(w)
    many = _work(passed=5_000_000, contribs=0)
    assert B.blend_fwd_bound_s(many) == pytest.approx(
        5_000_000 / B.PEAK_SFU_PER_S)


def test_operation_counts_at_a_small_size():
    model = {"feat_dim": 32, "n_offsets": 10, "num_channels": 15}
    # level 0: 6 planes x 4 corners x 5 channels x 2; heads 30 -> 32 and
    # 71 -> 32 with their BatchNorm; three MLPs 99 -> 32 -> 10 / 70 / 30
    want = (240 + 4 * 30 + 2 * 30 * 32 + 4 * 71 + 2 * 71 * 32
            + 3 * 2 * 99 * 32 + 2 * 32 * (10 + 70 + 30))
    assert F.decode_ops(model, 0) == want
    assert F.linear_ops(model, 0) < F.decode_ops(model, 0)
    w = _work()
    frame = F.frame_ops(model, 256, 0, w)
    assert frame == (F.PREFILTER_OPS * 256 + want * 100 + 300 * 700
                     + 15 * 50_000 + 10 * 40_000)
    step = F.step_ops(model, 256, 0, [w, w], 1000)
    assert step > 2 * frame + F.ADAM_OPS * 1000


def test_reference_counts_what_the_blend_does():
    """The reference's work counts on a tiny scene agree with a direct
    count: every contribution passed the alpha test, every passing
    evaluation was evaluated."""
    import torch

    from bench_h100.reference.raster import bin_records, blend_fwd
    from bench_h100.reference.project import Cols
    gen = torch.Generator().manual_seed(3)
    n = 40
    mx = torch.rand(n, generator=gen) * 60
    my = torch.rand(n, generator=gen) * 40
    ca = torch.full((n,), 0.05)
    cc = torch.full((n,), 0.05)
    cb = torch.zeros(n)
    cols = Cols(mx, my, torch.rand(n, generator=gen) + 1.0, ca, cb, cc,
                torch.full((n,), 14.0))
    colors = torch.rand((n, 3), generator=gen)
    op = torch.rand(n, generator=gen) * 0.9 + 0.05
    b = bin_records(cols, colors, op, 64, 48, 32, 12)
    work = {}
    rgb, t = blend_fwd(b, 64, 48, work)
    assert work["pairs"] == b.records.shape[1] > 0
    assert work["contribs"] <= work["passed"] <= work["evals"]
    assert work["evals"] <= work["pairs"] * 32 * 32
    assert bool((t > 0).all()) and bool((t <= 1).all())


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "splatco_tpu"}


def test_harness_loads_no_jax_and_reference_no_program():
    tops = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    harness = _loaded("import bench_h100.harness.cell, "
                      "bench_h100.drivers.train, bench_h100.drivers.render, "
                      "bench_h100.harness.faults, bench_h100.calibrate; "
                      + tops)
    assert not harness & FORBIDDEN
    assert "splatco_torch" in harness  # the program, whose name is not
    reference = _loaded("import bench_h100.reference.step, "
                        "bench_h100.harness.counting; " + tops)
    assert not reference & (FORBIDDEN | {"splatco_torch"})
    from bench_h100.harness.cell import FORBIDDEN as CHECKED
    assert set(CHECKED) == FORBIDDEN
