"""Checkpoints, the reference import and the offline render CLI of
splatco_torch against splatco_tpu on the CPU.

Checkpoints and imports are held to JAX array for array and the anchor
PLY byte for byte; run configs load across the packages both ways.
`render_sets` on a COLMAP scene the JAX writer made writes the JAX
render_sets' PNGs: both quantize by truncation, so a ~1e-7 float
difference moves a pixel by one level where it sits on a boundary (at
most one level, under 1e-3 of the pixels); the ground-truth PNGs and
num_gaussians.json's anchor count are equal.  `render_torch.py --device
cpu` writes the in-process PNGs bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import torch
from PIL import Image
from test_import_reference import _export_reference_format
from test_torch_render import (flat_numpy, flat_numpy_torch, jax_model,
                               port_cfg)

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig, load_run_config,
                                  save_run_config)
from splatco_torch.eval.render_driver import load_trained, render_sets
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.train import checkpoint as ckpt
from splatco_torch.train.import_reference import load_reference_model
from splatco_tpu import config as j_config
from splatco_tpu.eval import render_driver as j_driver
from splatco_tpu.models.splatco import init_model as j_init_model
from splatco_tpu.train import checkpoint as j_ckpt
from splatco_tpu.train.import_reference import \
    load_reference_model as j_load_reference_model
from splatco_tpu.utils.synthetic import write_colmap_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = {"contractor_min": [-1.1, -0.9, -1.0],
        "contractor_max": [1.0, 1.2, 0.9], "activate_level": 1}


def assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], key)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A model the port saved reads back in JAX (and in the port) array
    for array; the anchor PLY is the JAX writer's byte for byte."""
    jcfg, params, state = jax_model(seed=6)
    tparams = params_from_numpy(flat_numpy(params), device="cpu")
    active = torch.as_tensor(np.array(state.active))
    active[5] = False  # a hole: only active anchors are written
    ckpt.save_model_checkpoint(str(tmp_path / "port"), 3, tparams, active,
                               META)
    j_ckpt.save_model_checkpoint(str(tmp_path / "jax"), 3, params,
                                 active.numpy(), META)
    rel = os.path.join("point_cloud", "iteration_3")
    for name in ("point_cloud.ply", "meta.json"):
        assert (tmp_path / "port" / rel / name).read_bytes() == \
            (tmp_path / "jax" / rel / name).read_bytes(), name

    jparams, jactive, jmeta = j_ckpt.load_model_checkpoint(
        str(tmp_path / "port"), 3, params)
    got, gactive, gmeta = ckpt.load_model_checkpoint(str(tmp_path / "port"),
                                                     3, device="cpu")
    assert jmeta == gmeta == META
    assert_flat_equal(flat_numpy_torch(got), flat_numpy(jparams))
    np.testing.assert_array_equal(gactive.numpy(), np.asarray(jactive))
    assert int(gactive.sum()) == int(active.sum())
    want = flat_numpy(params)
    for key, val in flat_numpy(jparams).items():
        if not key.startswith("['anchors']"):
            np.testing.assert_array_equal(val, want[key], key)
    keep = active.numpy()
    n = int(keep.sum())
    np.testing.assert_array_equal(
        np.asarray(jparams["anchors"]["offsets"])[:n],
        np.asarray(params["anchors"]["offsets"])[keep])


def test_train_state_round_trips(tmp_path):
    """save_train_state / load_train_state keep every leaf and dtype, the
    JAX loader reads the archive into the same structure, and
    latest_train_checkpoint finds the newest."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": [torch.as_tensor(rng.normal(size=(3, 4)),
                                             dtype=torch.float32),
                             torch.zeros(2)]},
            "count": torch.tensor(7, dtype=torch.int32),
            "active": torch.as_tensor(rng.random(9) > 0.5),
            "key": torch.tensor([1, 2], dtype=torch.int32)}
    meta = {"iteration": 40, "level": 1}
    assert ckpt.latest_train_checkpoint(str(tmp_path)) is None
    for it in (10, 40):
        ckpt.save_train_state(str(tmp_path), it, tree, meta)
    assert ckpt.latest_train_checkpoint(str(tmp_path)) == 40
    got, got_meta = ckpt.load_train_state(str(tmp_path), 40, device="cpu")
    assert got_meta == meta
    assert_flat_equal(flat_numpy_torch(got), flat_numpy_torch(tree))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.numpy(
        ).dtype), tree)
    jtree, jmeta = j_ckpt.load_train_state(str(tmp_path), 40, template)
    assert jmeta == meta
    assert_flat_equal(flat_numpy(jtree), flat_numpy_torch(tree))


def test_run_config_loads_across_packages(tmp_path):
    port = (ModelConfig(feat_dim=8, scene_center=[1.0, 2.0, 3.0]),
            PipelineConfig(mv=2), OptimizationConfig(iterations=9))
    save_run_config(str(tmp_path / "port"), *port)
    got = j_config.load_run_config(str(tmp_path / "port"))
    assert [dataclasses.asdict(c) for c in got] == [
        dataclasses.asdict(c) for c in port]
    jax_ = (j_config.ModelConfig(n_offsets=3, eval=False),
            j_config.PipelineConfig(), j_config.OptimizationConfig(
                graph_downsampling_iters=[5, 6]))
    j_config.save_run_config(str(tmp_path / "jax"), *jax_)
    got = load_run_config(str(tmp_path / "jax"))
    assert [dataclasses.asdict(c) for c in got] == [
        dataclasses.asdict(c) for c in jax_]


def test_reference_import_matches_jax(tmp_path):
    """A model written in the reference's torch layout imports equal to
    JAX load_reference_model, with and without its chkpnt file, and
    load_trained takes the reference branch."""
    jcfg = j_config.ModelConfig(
        feat_dim=8, n_offsets=4, voxel_size=0.05, plane_size=32,
        num_channels=9, appearance_dim=4, contractor=True,
        scene_center=[0, 0, 0], scene_length=[4, 4, 4])
    pts = np.random.default_rng(1).normal(size=(200, 3)).astype(np.float32)
    params, state = j_init_model(jax.random.key(3), jcfg, pts, num_cameras=4)
    bounds = (np.asarray(state.contractor.xyz_min) - 0.25,
              np.asarray(state.contractor.xyz_max) + 0.5)
    model = str(tmp_path / "ref")
    _export_reference_format(model, params, np.asarray(state.active), 30,
                             bounds)
    cfg = port_cfg(jcfg)
    cap = params["anchors"]["anchor"].shape[0]
    got, active, got_bounds = load_reference_model(model, 30, cfg,
                                                   capacity=cap,
                                                   device="cpu")
    want, jactive, jbounds = j_load_reference_model(model, 30, params,
                                                    capacity=cap)
    assert_flat_equal(flat_numpy_torch(got), flat_numpy(want))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    for a, b in zip(got_bounds, jbounds):
        np.testing.assert_array_equal(a, b)

    cfg.model_path = model
    _, _, contractor, level, it = load_trained(cfg, device="cpu")
    assert (level, it) == (2, 30)
    np.testing.assert_array_equal(contractor.xyz_max.numpy(), bounds[1])

    os.remove(os.path.join(model, "chkpnt30.pth"))  # a PLY-only export
    got, _, got_bounds = load_reference_model(model, 30, cfg, device="cpu")
    want, _, _ = j_load_reference_model(model, 30, params)
    assert got_bounds is None
    flat_got, flat_want = flat_numpy_torch(got), flat_numpy(want)
    assert {k: v.shape for k, v in flat_got.items()} == {
        k: v.shape for k, v in flat_want.items()}
    for key in flat_want:
        if not key.startswith("['planes']"):
            np.testing.assert_array_equal(flat_got[key], flat_want[key], key)


def read_png(path):
    return np.asarray(Image.open(path), np.int16)


def test_render_sets_matches_jax(tmp_path):
    """A JAX-trained model of a COLMAP scene through the port's
    render_sets and render_torch.py, against JAX render_sets."""
    scene = str(tmp_path / "scene")
    write_colmap_dataset(scene, n_views=2, width=96, height=64)
    jcfg, params, state = jax_model(seed=4)
    jcfg.source_path = scene
    jcfg.model_path = str(tmp_path / "jax")
    j_ckpt.save_model_checkpoint(jcfg.model_path, 7, params, state.active,
                                 META)
    j_config.save_run_config(jcfg.model_path, jcfg, j_config.PipelineConfig(),
                             j_config.OptimizationConfig())
    for side in ("port", "cli"):
        shutil.copytree(jcfg.model_path, tmp_path / side)

    j_fps, j_n = j_driver.render_sets(jcfg)
    cfg = port_cfg(jcfg)
    cfg.model_path = str(tmp_path / "port")
    fps, n = render_sets(cfg, device="cpu")
    assert n == j_n == int(np.asarray(state.active).sum())
    assert set(fps) == set(j_fps) == {"train", "test"}
    for side in ("jax", "port"):
        with open(tmp_path / side / "num_gaussians.json") as fh:
            assert json.load(fh)[side] == n

    for split in ("train", "test"):  # one view each
        out = os.path.join(split, "ours_7")
        for side in ("jax", "port"):
            assert os.listdir(tmp_path / side / out / "renders") == [
                "00000.png"]
        for name in ["00000.png"]:
            a = read_png(tmp_path / "jax" / out / "renders" / name)
            b = read_png(tmp_path / "port" / out / "renders" / name)
            assert a.shape == b.shape == (64, 96, 3)
            assert np.abs(a - b).max() <= 1
            assert (a != b).mean() < 1e-3
            assert a.std() > 0
            np.testing.assert_array_equal(
                read_png(tmp_path / "jax" / out / "gt" / name),
                read_png(tmp_path / "port" / out / "gt" / name))

    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "render_torch.py"), "-m",
         str(tmp_path / "cli"), "--skip_train", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert not (tmp_path / "cli" / "train").exists()
    out = os.path.join("test", "ours_7", "renders", "00000.png")
    assert (tmp_path / "cli" / out).read_bytes() == \
        (tmp_path / "port" / out).read_bytes()
