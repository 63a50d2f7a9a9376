"""The hard quality protocol of the port on the CPU: the hard scene
(utils/synthetic.py make_hard_cloud, hard_camera, write_hard_dataset)
against the JAX package's, and the three tools that run on it --
tools/quality_run_torch.py --hard, tools/ablation_run_torch.py and
tools/finalize_quality_run_torch.py -- at a toy size.

Tolerances: the cloud, the cameras, transforms_*.json and points3d.ply
exactly (byte for byte); the ground-truth PNGs within one level (1/255)
of the JAX writer's, whose dense oracle the port's binned blend matches
to ~3e-5.  TensorBoard is hidden from the trainers, which then log
without it: importing it takes ~15 s here.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from splatco_torch.utils import synthetic as t_syn
from splatco_tpu.utils import synthetic as j_syn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import ablation_run_torch  # noqa: E402
import finalize_quality_run_torch  # noqa: E402
import quality_run_torch  # noqa: E402

VIEWS, W, H = 8, 64, 48
QUALITY_ITERS, ABLATION_ITERS = 24, 8
# the reference's eval iterations scaled to 24 of 30,000
EVALS = [2, 5, 9, 13, 17, 24]
SCENE_ARGS = ["--device", "cpu", "--views", str(VIEWS), "--points", "400",
              "--width", str(W), "--height", str(H), "--arc_period", "2"]


@pytest.fixture(autouse=True)
def quiet_and_one_thread(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hard_cloud_and_rig_match_jax():
    for n, seed in ((3500, 0), (400, 3)):
        for a, b in zip(t_syn.make_hard_cloud(n, seed),
                        j_syn.make_hard_cloud(n, seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for total, period in ((28, 3), (8, 2)):
        for i in range(total):
            jc = j_syn.hard_camera(i, total, 320, 224, arc_period=period)
            tc = t_syn.hard_camera(i, total, 320, 224, arc_period=period,
                                   device="cpu")
            for f in ("world_view_transform", "full_proj_transform",
                      "camera_center"):
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)))
            assert (tc.uid, tc.fovx, tc.fovy) == (int(jc.uid), jc.fovx,
                                                  jc.fovy)
    assert (t_syn.ARC_TH0, t_syn.ARC_DTH, t_syn.ARC_R, t_syn.ARC_Y0,
            t_syn.ARC_DY, t_syn.ARC_STATIONS) == (
        j_syn.ARC_TH0, j_syn.ARC_DTH, j_syn.ARC_R, j_syn.ARC_Y0,
        j_syn.ARC_DY, j_syn.ARC_STATIONS)


def test_hard_dataset_matches_the_jax_writer(tmp_path):
    j_syn.write_hard_dataset(str(tmp_path / "jax"), n_views=VIEWS,
                             n_pts=500, width=W, height=H)
    t_syn.write_hard_dataset(str(tmp_path / "port"), n_views=VIEWS,
                             n_pts=500, width=W, height=H, device="cpu")
    for name in ("transforms_train.json", "transforms_test.json",
                 "points3d.ply"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    pngs = [os.path.join(split, f) for split in ("train", "test")
            for f in sorted(os.listdir(tmp_path / "jax" / split))]
    assert len(pngs) == VIEWS
    for name in pngs:
        a = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1, name
        assert a.std() > 0


@pytest.fixture(scope="module")
def quality_run(tmp_path_factory):
    """quality_run_torch.main --hard at a toy size: (args, payload)."""
    tmp = tmp_path_factory.mktemp("hard_quality")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    try:
        paths = {"scene": str(tmp / "scene"), "model": str(tmp / "model"),
                 "out": str(tmp / "res.json")}
        payload = quality_run_torch.main(
            ["--hard", "--iterations", str(QUALITY_ITERS),
             "--skip_artifacts", *SCENE_ARGS,
             *(a for k, v in paths.items() for a in (f"--{k}", v))])
    finally:
        sys.modules["torch.utils.tensorboard"] = saved
        torch.set_num_threads(n)
    return paths, payload


def test_quality_run_hard(quality_run):
    paths, payload = quality_run
    with open(paths["out"]) as fh:
        assert json.load(fh) == json.loads(json.dumps(payload))
    assert payload["config"]["iterations"] == QUALITY_ITERS
    assert payload["config"]["backend"] == "plain"
    assert all(np.isfinite(v) for v in payload["final_test"].values())
    evals = [m for m in payload["trajectory"] if "test_psnr" in m]
    assert [m["iteration"] for m in evals] == EVALS
    assert all(np.isfinite(m["test_psnr"]) for m in evals)
    # the hard scene: transforms written by write_hard_dataset
    with open(os.path.join(paths["scene"], "transforms_train.json")) as fh:
        frames = json.load(fh)["frames"]
    assert len(frames) == VIEWS - VIEWS // 4


def test_finalize_reproduces_the_finished_run(quality_run, tmp_path):
    """Restored from the run's last checkpoint, the finalize tool scores
    the same model: its final metrics equal the run's."""
    paths, payload = quality_run
    out = str(tmp_path / "final.json")
    fin = finalize_quality_run_torch.main(
        ["--scene", paths["scene"], "--model", paths["model"],
         "--out", out, "--iterations", str(QUALITY_ITERS),
         "--skip_artifacts", *SCENE_ARGS[:2]])
    assert fin["finalized_from_checkpoint"] == QUALITY_ITERS
    assert fin["final_test"] == payload["final_test"]
    assert fin["anchors_final"] == payload["anchors_final"]
    assert [e["iteration"] for e in fin["events"] if "psnr" in e
            and e["split"] == "test"] == EVALS
    assert [t["iteration"] for t in fin["trajectory"]] == [10, 20]
    with open(out) as fh:
        assert json.load(fh)["config"]["hard_protocol"] is True


def test_ablation_run_writes_four_variants(tmp_path):
    out = str(tmp_path / "ablation.json")
    payload = ablation_run_torch.main(
        ["--hard", "--iterations", str(ABLATION_ITERS), "--work",
         str(tmp_path / "work"), "--out", out, *SCENE_ARGS])
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(payload))
    v = payload["variants"]
    assert list(v) == ["baseline", "no_multilevel", "no_consistency",
                       "no_cvpm"]
    for name, res in v.items():
        assert all(np.isfinite(x) for x in res["final_test"].values())
        if name != "baseline":
            assert sorted(res["delta_vs_baseline"]) == ["flip", "psnr",
                                                        "ssim"]
    assert payload["config"]["hard_protocol"] is True
