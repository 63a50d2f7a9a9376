"""The port's popping harness on the CPU against the JAX package: RAFT
(splatco_torch/eval/raft.py) with JAX's init_raft_params(key(0)) carried
across, part by part and whole; the checkpoint loaders; the warp and the
occlusion test (eval/popping.py) against OpenCV and JAX;
validate_popping against JAX's on a seeded stream with the same
Farneback flow; detect_popping_torch.py in a subprocess;
tools/profile_torch_eval.py at a small size.

Tolerances: RAFT's parts 1e-5 of the largest |value| (float32 convs and
sums in another order), its flow after 3 iterations 2e-3 x max(|flow|,
1) (the recurrence carries the differences on); the warp 1e-6 of
cv2.remap; occlusion masks equal away from 1e-4 (relative) of the
threshold, where float rounding can flip them; popping aggregates 1e-5
relative.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.data.images import save_png
from splatco_torch.eval import popping, raft
from splatco_tpu.eval import popping as j_popping
from splatco_tpu.eval import raft as j_raft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PART_TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same carried into the port on the CPU); the init
    is jitted: one compile instead of one per parameter shape."""
    jp = jax.jit(j_raft.init_raft_params)(jax.random.key(0))
    return jp, raft.raft_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ----------------------------------------------------------------------
# RAFT
# ----------------------------------------------------------------------

def test_param_layout_matches_jax(params):
    jp, _ = params
    mine = raft.init_raft_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert sorted(mine) == sorted(jp)
    for k, v in jp.items():
        assert tuple(mine[k].shape) == v.shape, k
        if k.endswith(("bias", "running_mean")):
            assert not mine[k].any(), k


@pytest.mark.parametrize("prefix,norm", [("fnet", "instance"),
                                         ("cnet", "batch")])
def test_basic_encoder_matches_jax(params, prefix, norm):
    jp, tp = params
    x = np.random.default_rng(0).uniform(-1, 1, size=(1, 3, 64, 96))
    got = raft.basic_encoder(tp, prefix, t(x), norm)
    want = j_raft.basic_encoder(jp, prefix, jnp.asarray(x, jnp.float32),
                                norm)
    assert got.shape == (1, 256, 8, 12)
    assert rel_err(got, want) <= PART_TOL


def test_corr_pyramid_lookup_and_upsample_match_jax():
    rng = np.random.default_rng(1)
    f1, f2 = (rng.normal(size=(1, 256, 8, 12)).astype(np.float32)
              for _ in range(2))
    pyr = raft.build_corr_pyramid(t(f1), t(f2))
    j_pyr = j_raft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert [tuple(p.shape) for p in pyr] == [p.shape for p in j_pyr]
    for got, want in zip(pyr, j_pyr):
        assert rel_err(got, want) <= PART_TOL
    # coordinates that leave the grid, so the zero padding is read, and
    # the level-0 centre tap (channel 40) at the identity
    gy, gx = np.meshgrid(np.arange(8.0), np.arange(12.0), indexing="ij")
    coords = (np.stack([gx, gy]) + rng.normal(scale=3.0, size=(2, 8, 12))
              ).astype(np.float32)
    got = raft.lookup_corr(pyr, t(coords))
    assert got.shape == (1, 4 * 81, 8, 12)
    assert rel_err(got, j_raft.lookup_corr(j_pyr, jnp.asarray(coords))
                   ) <= PART_TOL
    ident = raft.lookup_corr(pyr, t(np.stack([gx, gy])))
    raw = pyr[0][:, 0].reshape(96, 96).diagonal().reshape(8, 12)
    assert rel_err(ident[0, 40], raw) <= PART_TOL
    # the reference's transposed tap order: channel 1, window cell (0, 1),
    # is offset by -4 in x and -3 in y
    c0 = pyr[0][:, 0].reshape(8, 12, 8, 12)
    want1 = torch.stack([torch.stack([c0[y, x, y - 3, x - 4]
                                      for x in range(4, 12)])
                         for y in range(3, 8)])
    assert rel_err(ident[0, 1, 3:, 4:], want1) <= PART_TOL
    flow = rng.normal(size=(1, 2, 4, 6)).astype(np.float32)
    mask = rng.normal(size=(1, 576, 4, 6)).astype(np.float32)
    got = raft.upsample_flow(t(flow), t(mask))
    assert got.shape == (1, 2, 32, 48)
    assert rel_err(got, j_raft.upsample_flow(jnp.asarray(flow),
                                             jnp.asarray(mask))) <= PART_TOL


def test_raft_flow_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 255, size=(1, 3, 64, 96)).astype(np.float32)
    img2 = np.roll(img1, 3, axis=3)
    got = raft.raft_flow(tp, t(img1), t(img2), iters=3).numpy()
    want = np.asarray(j_raft.raft_flow(jp, jnp.asarray(img1),
                                       jnp.asarray(img2), iters=3))
    assert got.shape == (1, 2, 64, 96) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-3 * max(np.abs(want).max(), 1.0)
    assert np.abs(want).max() > 0.1


def test_make_flow_fn_pads_as_jax(params):
    """A 60x90 pair is zero-padded to 64x96 and the flow cropped back."""
    jp, tp = params
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(60, 90, 3)).astype(np.float32)
    b = np.roll(a, 2, axis=0)
    got = raft.make_flow_fn(tp, iters=3, device="cpu")(t(a), t(b))
    want = j_raft.make_flow_fn(jp, iters=3)(a, b)
    assert got.shape == (60, 90, 2)
    assert np.abs(got.numpy() - want).max() <= 2e-3 * max(
        np.abs(want).max(), 1.0)


def test_checkpoint_loaders_agree(params, tmp_path):
    """A .pth in the official layout ("module." keys, batch-norm counters)
    written by the port reads the same through both loaders."""
    _, tp = params
    path = str(tmp_path / "raft.pth")
    raft.save_raft_weights(tp, path)
    sd = torch.load(path, weights_only=True)
    assert all(k.startswith("module.") for k in sd)
    assert "module.cnet.norm1.num_batches_tracked" in sd
    assert len(sd) == len(tp) + sum(k.endswith("running_var") for k in tp)
    mine = raft.load_raft_weights(path, device="cpu")
    theirs = j_raft.load_raft_weights(path)
    assert sorted(mine) == sorted(theirs) == sorted(tp)
    for k, v in theirs.items():
        assert mine[k].dtype == torch.float32
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(mine[k].numpy(), tp[k].numpy())


# ----------------------------------------------------------------------
# the warp, the occlusion test, the harness
# ----------------------------------------------------------------------

def test_warp_matches_cv2_remap():
    """warp_with_flow samples as cv2.remap(INTER_LINEAR, BORDER_REPLICATE)
    samples one-, three- and four-channel images, flows leaving the image
    included; a two-channel image cv2 samples at coordinates rounded to
    1/32 px, which the occlusion test's warp of the flow reproduces."""
    import cv2

    rng = np.random.default_rng(4)
    h, w = 48, 64
    flow = (rng.normal(size=(h, w, 2)) * 6).astype(np.float32)
    flow[0, 0], flow[5, 7] = (1e3, -1e3), (-70.0, 80.0)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    mx = (gx + flow[..., 0]).astype(np.float32)
    my = (gy + flow[..., 1]).astype(np.float32)
    for c in (1, 3, 4):
        img = rng.uniform(size=(h, w, c)).astype(np.float32)
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE).reshape(h, w, c)
        got = popping.warp_with_flow(t(img), t(flow)).numpy()
        assert np.abs(got - want).max() <= 1e-6, c
    img = rng.uniform(size=(h, w, 2)).astype(np.float32)
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)
    q = popping._FLOW_WARP_STEPS
    got = popping._sample(t(img), torch.round(t(mx) * q) / q,
                          torch.round(t(my) * q) / q).numpy()
    assert np.abs(got - want).max() <= 1e-6
    exact = popping.warp_with_flow(t(img), t(flow)).numpy()
    assert np.abs(exact - want).max() > 1e-3  # the rounding shows


def test_detect_occlusion_matches_jax():
    rng = np.random.default_rng(5)
    h, w = 48, 64
    checked = 0
    for scale in (1.0, 4.0, 10.0):
        fwd = (rng.normal(size=(h, w, 2)) * scale).astype(np.float32)
        bwd = (-fwd + rng.normal(size=(h, w, 2)) * 0.6).astype(np.float32)
        got = popping.detect_occlusion(t(fwd), t(bwd)).numpy()
        want = j_popping.detect_occlusion(fwd, bwd)
        warped = j_popping.warp_with_flow(bwd, fwd)
        thr = 0.01 * ((fwd ** 2).sum(-1) + (warped ** 2).sum(-1)) + 0.5
        away = np.abs(((fwd + warped) ** 2).sum(-1) - thr) > 1e-4 * thr
        np.testing.assert_array_equal(got[away], want[away])
        assert 0 < want.mean() < 1
        checked += away.sum()
    assert checked > 0.99 * 3 * h * w


def write_stream(path, frames, seed, size=(48, 64)):
    """`frames` frames of a textured background sliding right and a square
    sliding left over it (so some pixels are occluded)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, size=size + (3,))
    square = rng.uniform(0.0, 1.0, size=(18, 18, 3))
    os.makedirs(path, exist_ok=True)
    for i in range(frames):
        frame = np.roll(base, i, axis=1)
        frame[17:35, 36 - 3 * i:54 - 3 * i] = square
        frame = np.clip(frame + rng.normal(size=frame.shape) * 0.01, 0, 1)
        save_png(os.path.join(path, f"{i:05d}.png"),
                 frame.transpose(2, 0, 1))


def test_validate_popping_matches_jax(tmp_path):
    renders, gts = str(tmp_path / "renders"), str(tmp_path / "gt")
    write_stream(renders, 4, seed=6)
    write_stream(gts, 4, seed=7)
    got = popping.validate_popping(
        renders, gts, steps=(1, 2), out_json=str(tmp_path / "pop.json"),
        plot_dir=str(tmp_path / "plots"), device="cpu")
    want = j_popping.validate_popping(renders, gts, steps=(1, 2))
    assert list(got) == list(want) == ["step_1", "step_2"]
    for step, res in want.items():
        assert list(got[step]["aggregate"]) == list(res["aggregate"])
        for key, val in res["aggregate"].items():
            assert got[step]["aggregate"][key] == pytest.approx(
                val, rel=1e-5), (step, key)
        fracs = [e["render"]["valid_frac"] for e in res["frames"]]
        assert [e["render"]["valid_frac"]
                for e in got[step]["frames"]] == pytest.approx(fracs,
                                                               abs=1e-3)
        if step == "step_1":
            assert min(fracs) < 1.0  # the square occludes
    with open(tmp_path / "pop.json") as fh:
        assert json.load(fh)["step_2"]["aggregate"] == got["step_2"][
            "aggregate"]
    assert (tmp_path / "plots" / "test_all_step_2.png").exists()


def test_farneback_needs_opencv(monkeypatch):
    """Without OpenCV the default estimator raises; nothing else takes its
    place."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frame = torch.zeros((16, 16, 3))
    with pytest.raises(ImportError):
        popping.flow_farneback(frame, frame)


def run_cli(*args):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "detect_popping_torch.py"),
         *args, "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_detect_popping_cli_on_the_cpu(tmp_path):
    """detect_popping_torch.py --device cpu, with Farneback and with RAFT
    from a checkpoint in the official layout (random weights; its four
    correlation levels need 64 px a side)."""
    frames = str(tmp_path / "frames")
    write_stream(frames, 3, seed=8, size=(64, 96))
    pth = str(tmp_path / "raft.pth")
    raft.save_raft_weights(raft.init_raft_params(
        torch.Generator().manual_seed(1), device="cpu"), pth)
    for flow in ("farneback", "raft"):
        out = str(tmp_path / f"{flow}.json")
        extra = ["--weights", pth, "--iters", "2"] if flow == "raft" else []
        log = run_cli("--render_dir", frames, "--steps", "1", "2",
                      "--flow", flow, "--out", out, *extra)
        with open(out) as fh:
            res = json.load(fh)
        assert [len(res[s]["frames"]) for s in ("step_1", "step_2")] == [
            2, 1]
        for step in res.values():
            assert all(np.isfinite(v) for v in step["aggregate"].values())
            assert all(0 <= e["render"]["valid_frac"] <= 1
                       for e in step["frames"])
        assert "step_1" in log
    with pytest.raises(SystemExit):
        import detect_popping_torch

        detect_popping_torch.main(["--render_dir", frames, "--flow", "raft",
                                   "--device", "cpu"])


def test_profile_tool_on_the_cpu():
    """tools/profile_torch_eval.py runs every stage at a small size on the
    CPU, times nothing there, and counts the convolutions' and products'
    operations."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_eval", os.path.join(REPO, "tools",
                                           "profile_torch_eval.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res = tool.run(torch.device("cpu"), width=96, height=64, iters=2,
                   reps=1, seed=0)
    assert res["device"] == "cpu" and res["size"] == [64, 96]
    assert sorted(res["metrics"]) == ["FLIP", "FLIP convolutions", "LPIPS",
                                      "PSNR", "SSIM"]
    assert all(m["ms"] is None for m in res["metrics"].values())
    assert 0 < res["metrics"]["FLIP convolutions"]["flops"] <= res[
        "metrics"]["FLIP"]["flops"]
    assert res["metrics"]["LPIPS"]["flops"] > 0
    assert res["raft_flow"]["flops"] > 0
    assert res["cudnn"] == "timed"
    assert res["first_flow_peak_gib"] is res["raft_flow"]["ms"] is None
    assert list(res["raft_stages_ms"]) == [
        "fnet encoder", "cnet encoder", "pyramid", "lookup", "update block",
        "upsample"]
