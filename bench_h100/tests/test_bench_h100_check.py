"""The check that decides `correct`, driven through the rest of a run on
the CPU at a small size (the look for a card skipped): a sound run
passes; the TF32 control in the program's place and each planted fault
of the timed path fail.  One card test runs a cell as the driver does.

    python -m pytest bench_h100/tests -q
    python -m pytest bench_h100/tests -q -m gpu   # on the card
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.harness import cell, check, faults, spec  # noqa: E402
from bench_h100.harness import program as prog  # noqa: E402
from bench_h100.reference.numerics import Numerics, to_tf32  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11  # the driver's seeds are this large


def _copy(factory, anchors: int, width: int, height: int) -> Path:
    """A copy of the benchmark at a size the CPU runs: `anchors` anchors,
    planes of 32 and 64 texels, width x height images, 8 cameras; the
    widths and the limits as they are."""
    root = factory.mktemp("bench")
    base = root / "bench_h100"
    for sub in ("configs", "traffic", "metrics", "drivers"):
        shutil.copytree(ROOT / "bench_h100" / sub, base / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (base / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["scene"].update(anchors=anchors, scale=0.08)
        c["model"]["plane_size"] = 128
        c["render"].update(width=width, height=height)
        path.write_text(json.dumps(c))
    for path in (base / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(cameras=8, trace_warmup=1)
        if t["driver"] == "render":
            t["check_frames"] = 2
        path.write_text(json.dumps(t))
    torch.set_num_threads(4)
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """256 anchors, 48 x 32 images: seconds a run."""
    return _copy(tmp_path_factory, 256, 48, 32)


@pytest.fixture(scope="module")
def control_size(tmp_path_factory):
    """1,024 anchors, 96 x 64 images: the smallest size tried at which
    the TF32 control's readings come near the cell's (loss_gap 1.2e-3 to
    1.4e-3, grad_gap 3.8e-3 to 5.6e-3 on three seeds; at 256 anchors and
    48 x 32 they read ten and two times lower, under the limits)."""
    return _copy(tmp_path_factory, 1024, 96, 64)


def _run(tiny, workload, seconds=0.05, fault=None, trace=False):
    bench = spec.load_benchmark(tiny)
    t0 = time.perf_counter()
    if fault is None:
        return cell.execute(bench, workload, SEED, seconds, trace, CPU, t0,
                            base=tiny / "bench_h100")
    with faults.planted(fault):
        return cell.execute(bench, workload, SEED, seconds, trace, CPU, t0,
                            base=tiny / "bench_h100")


TRAIN = ["train-qs-v2", "train-qs-v3"]
RENDER = ["render-qs-v2", "render-qs-v3"]


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_training_run_is_correct(tiny, workload):
    res = _run(tiny, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the CPU has no device allocator whose peak train_peak_mem_gib reads
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_planted_training_fault_is_not_correct(tiny, fault, workload):
    res = _run(tiny, workload, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", RENDER)
def test_sound_render_run_is_correct(tiny, workload):
    res = _run(tiny, workload, seconds=4.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 8
    assert set(res["metrics"]) == {"render_frame_ms", "setup_s"}


@pytest.mark.parametrize("workload", RENDER)
def test_altered_frames_are_not_correct(tiny, workload):
    res = _run(tiny, workload, seconds=4.0, fault="altered")
    assert not res["correct"], res["checks"]


def test_render_window_missing_a_camera_is_not_correct(tiny):
    """A sampled camera the window never drew: its answer never came."""
    res = _run(tiny, "render-qs-v2", seconds=0.0)
    assert not res["correct"]


def test_nonfinite_frames_fail(tiny, monkeypatch):
    """A frame whose image is not finite counts as failed."""
    render = prog.render

    def nan_image(*a, **kw):
        out = render(*a, **kw)
        return out._replace(image=out.image * float("nan"))

    monkeypatch.setattr(prog, "render", nan_image)
    res = _run(tiny, "render-qs-v2", seconds=1.0)
    assert res["failed"] == res["attempted"] > 0
    assert not res["correct"]


@pytest.mark.parametrize("workload", TRAIN + RENDER)
def test_traced_run_reads_per_layer_metrics(tiny, workload, monkeypatch):
    """A traced run on the CPU: the trace is read and the per-layer
    metrics that need no device events are reported; a render run's
    latencies come from the untraced stretch before the trace."""
    monkeypatch.setattr(cell, "TRACE_SECONDS", 0.5)
    monkeypatch.setattr(spec.driver("render", tiny / "bench_h100"),
                        "LATENCY_SECONDS", 10.0)
    # a CPU frame takes a quarter of a second: the p95 reader wants 20
    res = _run(tiny, workload, seconds=12.0, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["window_s"] > 0
    bench = spec.load_benchmark(tiny)
    allowed = {m["name"] for m in spec.metrics_of(bench, workload,
                                                  "per_layer")}
    assert set(res["metrics"]) <= allowed
    if workload.startswith("render"):
        assert "render_frame_p95_ms.host" in res["metrics"]


@pytest.mark.parametrize("workload", TRAIN + RENDER)
def test_tf32_control_is_not_correct(control_size, workload):
    root = control_size
    bench = spec.load_benchmark(root)
    w = spec.cell(bench, workload)
    cfg = spec.config(bench, w["config"], root)
    traffic = spec.traffic(w["traffic"], root / "bench_h100")
    read = spec.driver(traffic["driver"], root / "bench_h100").readings
    got = read(cfg, traffic, SEED, CPU, True, [])
    assert check.judge(got["program"], traffic["limits"])[0]
    assert not check.judge(got["control"], traffic["limits"])[0]
    if traffic["driver"] == "train":
        # the control's backward is computed (at TF32), not cut: a cut
        # graph reads a gradient gap of exactly 1
        assert got["control"]["grad_gap"] < 0.5


@pytest.mark.parametrize("op", ["mm", "conv2d"])
def test_tf32_products_round_operands_and_cotangents(op):
    """The control's products, forward and backward, are those of TF32
    tensor cores: rounded operands and cotangent, float32 sums."""
    gen = torch.Generator().manual_seed(5)
    num = Numerics("tf32")
    if op == "mm":
        a = torch.randn(6, 9, generator=gen, requires_grad=True)
        b = torch.randn(9, 4, generator=gen, requires_grad=True)

        def plain(x, y):
            return x @ y

        out = num.mm(a, b)
    else:
        a = torch.randn(1, 3, 10, 10, generator=gen, requires_grad=True)
        b = torch.randn(3, 1, 3, 3, generator=gen, requires_grad=True)

        def plain(x, y):
            return torch.nn.functional.conv2d(x, y, padding=1, groups=3)

        out = num.conv2d(a, b, padding=1, groups=3)
    g = torch.randn(out.shape, generator=gen)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    ra = to_tf32(a.detach()).requires_grad_()
    rb = to_tf32(b.detach()).requires_grad_()
    want = plain(ra, rb)
    wa, wb = torch.autograd.grad(want, (ra, rb), to_tf32(g))
    assert torch.equal(out.detach(), want.detach())
    assert torch.allclose(ga, wa, rtol=0, atol=1e-6)
    assert torch.allclose(gb, wb, rtol=0, atol=1e-6)
    assert bool(ga.abs().sum() > 0) and bool(gb.abs().sum() > 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", TRAIN + RENDER)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
