"""The port's evaluation metrics on the CPU against the JAX package:
FLIP (splatco_torch/ops/flip.py) and LPIPS (ops/lpips.py) against the
reference goldens the JAX tests pin and against the JAX functions on
seeded inputs, the metrics driver (eval/metrics_driver.py) against
JAX's on a small model directory of seeded PNGs, metrics_torch.py in a
subprocess, and tools/quality_run_torch.py at a toy size.

Tolerances: against the goldens, the JAX tests' own (map 2e-3, mean
2e-4, HDR means 3e-4); against JAX on the same inputs, the FLIP map
1e-4 and its means 1e-5 (the same float32 operations, summed in another
order: measured ~3e-6 on the map), LPIPS 1e-4 relative, the metrics
driver's PSNR 1e-4 dB and the rest 1e-5.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.data.images import save_png
from splatco_torch.eval import metrics_driver
from splatco_torch.ops import flip, lpips
from splatco_tpu.eval import metrics_driver as j_metrics_driver
from splatco_tpu.ops import flip as j_flip
from splatco_tpu.ops import lpips as j_lpips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
TONE_MAPPERS = ("aces", "hable", "reinhard")


def golden(name):
    with np.load(os.path.join(GOLDEN, f"{name}.npz")) as g:
        return {k: g[k] for k in g.files}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def seeded_pair(seed, shape=(3, 48, 64), hdr=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    if hdr:  # linear radiance over several stops
        a, b = (np.exp2(8 * x - 4).astype(np.float32) for x in (a, b))
    return a, b


# ----------------------------------------------------------------------
# FLIP
# ----------------------------------------------------------------------

def test_ldr_flip_matches_reference_golden():
    g = golden("flip_golden")
    got = flip.ldr_flip_error_map(t(g["img_b"]), t(g["img_a"])).numpy()
    assert got.shape == g["flip_map"].shape
    np.testing.assert_allclose(got, g["flip_map"], atol=2e-3)
    np.testing.assert_allclose(float(flip.ldr_flip(t(g["img_b"]),
                                                   t(g["img_a"]))),
                               float(g["flip_mean"]), atol=2e-4)


@pytest.mark.parametrize("tone_mapper", TONE_MAPPERS)
def test_hdr_flip_matches_reference_golden(tone_mapper):
    g = golden("hdr_flip_golden")
    got = float(flip.hdr_flip(t(g["img_b"]), t(g["img_a"]),
                              tone_mapper=tone_mapper))
    np.testing.assert_allclose(got, float(g[f"mean_{tone_mapper}"]),
                               atol=3e-4)


def test_ldr_flip_matches_jax():
    a, b = seeded_pair(0)
    got = flip.ldr_flip_error_map(t(a), t(b)).numpy()
    want = np.asarray(j_flip.ldr_flip_error_map(jnp.asarray(a),
                                                jnp.asarray(b)))
    assert np.abs(got - want).max() <= 1e-4
    assert abs(got.mean() - want.mean()) <= 1e-5
    assert want.mean() > 0.05  # the pair differs visibly
    assert flip._cmax(0.7, 1e-15) == pytest.approx(
        j_flip._cmax(0.7, 1e-15), rel=1e-6)


@pytest.mark.parametrize("tone_mapper", TONE_MAPPERS)
def test_hdr_flip_matches_jax(tone_mapper):
    a, b = seeded_pair(1, hdr=True)
    start, stop = flip.compute_start_stop_exposures(t(b), tone_mapper)
    assert (start, stop) == j_flip.compute_start_stop_exposures(
        b, tone_mapper)
    got = flip.hdr_flip_error_map(t(a), t(b), tone_mapper=tone_mapper)
    want = np.asarray(j_flip.hdr_flip_error_map(
        jnp.asarray(a), jnp.asarray(b), tone_mapper=tone_mapper))
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert abs(float(got.mean()) - float(want.mean())) <= 1e-5


def test_flip_filters_at_the_default_ppd():
    """The CSF kernels are 21x21 and the feature kernels 19x19 at ~67
    px/deg, each the JAX package's to the bit."""
    for got, want in zip(flip._csf_filters(flip.DEFAULT_PPD),
                         j_flip._csf_filters(j_flip.DEFAULT_PPD)):
        np.testing.assert_array_equal(got, want)
    assert flip._csf_filters(flip.DEFAULT_PPD)[0].shape == (21, 21)
    for feature in ("edge", "point"):
        gx, r = flip._feature_kernel(flip.DEFAULT_PPD, feature)
        assert gx.shape == (19, 19) and r == 9
        np.testing.assert_array_equal(
            gx, j_flip._feature_kernel(j_flip.DEFAULT_PPD, feature)[0])


# ----------------------------------------------------------------------
# LPIPS
# ----------------------------------------------------------------------

def test_lpips_matches_torch_golden():
    g = golden("lpips_golden")
    weights = {k: t(v) for k, v in g.items()
               if k.startswith(("conv", "lin"))}
    got = float(lpips.lpips(weights, t(g["img_a"]), t(g["img_b"])))
    np.testing.assert_allclose(got, float(g["lpips"]), rtol=1e-4)


@pytest.mark.parametrize("rescale", [False, True])
def test_lpips_matches_jax_at_vgg16_widths(rescale):
    w = lpips.random_weights(0)
    a, b = seeded_pair(2, shape=(3, 64, 64))
    got = float(lpips.lpips({k: t(v) for k, v in w.items()}, t(a), t(b),
                            rescale=rescale))
    want = float(j_lpips.lpips({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(a), jnp.asarray(b),
                               rescale=rescale))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_load_weights(tmp_path, monkeypatch):
    """By path or through SPLATCO_LPIPS_WEIGHTS, as float32 tensors on the
    device asked for; None without a file."""
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    assert lpips.load_weights(None, device="cpu") is None
    assert lpips.load_weights(str(tmp_path / "absent.npz"),
                              device="cpu") is None
    path = str(tmp_path / "w.npz")
    w = lpips.random_weights(1)
    np.savez(path, **w)
    monkeypatch.setenv(lpips.WEIGHTS_ENV, path)
    got = lpips.load_weights(device="cpu")
    assert sorted(got) == sorted(w)
    for k, v in w.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v)


# ----------------------------------------------------------------------
# the metrics driver and its CLI
# ----------------------------------------------------------------------

def write_model_dir(root, seed=0):
    """test/ours_7/{renders,gt} of two seeded 48x64 views (one a 4-channel
    PNG), and num_gaussians.json."""
    rng = np.random.default_rng(seed)
    mdir = os.path.join(root, "test", "ours_7")
    for view in range(2):
        gt = rng.uniform(size=(3, 48, 64)).astype(np.float32)
        render = np.clip(gt + rng.normal(scale=0.08, size=gt.shape), 0, 1)
        save_png(os.path.join(mdir, "gt", f"{view:05d}.png"), gt)
        save_png(os.path.join(mdir, "renders", f"{view:05d}.png"), render)
    # the reader takes the first three channels of an RGBA render
    from PIL import Image

    path = os.path.join(mdir, "renders", "00001.png")
    rgb = np.asarray(Image.open(path))
    alpha = np.full(rgb.shape[:2] + (1,), 200, np.uint8)
    Image.fromarray(np.concatenate([rgb, alpha], -1)).save(path)
    with open(os.path.join(root, "num_gaussians.json"), "w") as fh:
        json.dump({"model": 123, "fps": {}}, fh)


def test_metrics_driver_matches_jax(tmp_path):
    w = golden("lpips_golden")
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **{k: v for k, v in w.items()
                     if k.startswith(("conv", "lin"))})
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    write_model_dir(port)
    shutil.copytree(port, jax_dir)
    got = metrics_driver.evaluate([port], npz, device="cpu")[port]
    want = j_metrics_driver.evaluate([jax_dir], npz)[jax_dir]
    assert got["num_gaussians"] == want["num_gaussians"]
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(port, name)) as fh:
            a = json.load(fh)
        with open(os.path.join(jax_dir, name)) as fh:
            b = json.load(fh)
        assert list(a) == list(b) == ["ours_7"]
        assert list(a["ours_7"]) == list(b["ours_7"]) == [
            "SSIM", "PSNR", "LPIPS", "FLIP"]
    for key in ("SSIM", "PSNR", "LPIPS", "FLIP"):
        tol = 1e-4 if key == "PSNR" else 1e-5
        assert abs(got["full"]["ours_7"][key]
                   - want["full"]["ours_7"][key]) <= tol, key
        views = got["per_view"]["ours_7"][key]
        assert list(views) == ["00000.png", "00001.png"]
        for view, val in views.items():
            assert abs(val - want["per_view"]["ours_7"][key][view]) <= tol
    assert got["full"]["ours_7"]["LPIPS"] > 0


def test_metrics_cli_on_the_cpu(tmp_path):
    """metrics_torch.py --device cpu writes results.json, with LPIPS null
    when no weights are given."""
    model = str(tmp_path / "model")
    write_model_dir(model, seed=1)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop(lpips.WEIGHTS_ENV, None)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "metrics_torch.py"), "-m",
         model, "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(os.path.join(model, "results.json")) as fh:
        full = json.load(fh)["ours_7"]
    assert full["LPIPS"] is None
    assert all(np.isfinite(full[k]) for k in ("SSIM", "PSNR", "FLIP"))
    with open(os.path.join(model, "per_view.json")) as fh:
        assert json.load(fh)["ours_7"]["LPIPS"] is None


# ----------------------------------------------------------------------
# the quality run
# ----------------------------------------------------------------------

def test_quality_run_at_a_toy_size(tmp_path, monkeypatch):
    """tools/quality_run_torch.py trains a 64x48 Blender scene for a few
    iterations on the CPU and writes the JAX tool's payload, its offline
    artifacts included (render_sets, the metrics driver, 48 orbit frames
    through the popping harness).  TensorBoard is hidden from the trainer,
    which then logs without it: importing it takes ~15 s here."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    spec = importlib.util.spec_from_file_location(
        "quality_run_torch", os.path.join(REPO, "tools",
                                          "quality_run_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "res.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tool.main(["--iterations", "4", "--device", "cpu", "--views", "6",
                   "--points", "150", "--width", "64", "--height", "48",
                   "--scene", str(tmp_path / "scene"),
                   "--model", str(tmp_path / "model"), "--out", out])
    finally:
        torch.set_num_threads(threads)
    with open(out) as fh:
        payload = json.load(fh)
    assert sorted(payload) == sorted([
        "config", "offline_artifacts", "wall_seconds", "final_test",
        "final_test_per_view", "anchors_final", "kmax_pack_final",
        "class_spec_final", "trajectory"])
    assert payload["config"]["backend"] == "plain"
    assert all(np.isfinite(v) for v in payload["final_test"].values())
    art = payload["offline_artifacts"]
    assert sorted(art) == ["fps", "metrics", "num_gaussians", "popping",
                           "popping_flow"]
    model = str(tmp_path / "model")
    assert art["metrics"][model]["full"]["ours_4"]["LPIPS"] is None
    for step in ("step_1", "step_7"):
        assert all(np.isfinite(v) for v in art["popping"][step].values())
    assert len(os.listdir(os.path.join(model, "orbit", "renders"))) == 48
    for name in ("results.json", "per_view.json", "popping_results.json",
                 os.path.join("orbit", "plots", "test_all_step_7.png")):
        assert os.path.exists(os.path.join(model, name)), name
