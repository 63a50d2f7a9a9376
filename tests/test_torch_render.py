"""The render slice of splatco_torch as a whole, against splatco_tpu, on the
CPU: JAX-initialised models carried into the port, the committed golden
image, a JAX checkpoint rendered through the port's driver, and the
port's two package rules (no JAX imported, no quiet CPU fallback).

Tolerances: images at 3e-5, the bound the JAX package holds its own
golden render to; decoded attributes at 1e-5 relative / 1e-5 absolute
(matmul and BN sums in another order); integer outputs exactly.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_model_render import small_cfg

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.readers import CameraInfo, load_camera
from splatco_torch.data.scene import Scene
from splatco_torch.eval.metrics_driver import evaluate, evaluate_dir
from splatco_torch.eval.popping import validate_popping
from splatco_torch.eval.raft import (init_raft_params, load_raft_weights,
                                     make_flow_fn, raft_params_from_numpy)
from splatco_torch.eval.render_driver import (load_trained, render_set,
                                              render_sets)
from splatco_torch.models.contraction import Contractor, make_contractor
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import (decode_kwargs, init_model,
                                          params_from_numpy)
from splatco_torch.ops import lpips
from splatco_torch.train.checkpoint import (load_model_checkpoint,
                                            load_train_state)
from splatco_torch.train.import_reference import load_reference_model
from splatco_torch.train.optimizer import make_optimizer, opt_state_from_numpy
from splatco_torch.train.step import init_stats, make_train_step
from splatco_torch.utils.synthetic import (hard_camera,
                                           write_blender_dataset,
                                           write_colmap_dataset,
                                           write_hard_dataset)
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.eval import render_driver as j_driver
from splatco_tpu.models.contraction import Contractor as j_Contractor
from splatco_tpu.models import renderer as j_renderer
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs
from splatco_tpu.models.splatco import init_model as j_init_model
from splatco_tpu.train import checkpoint as j_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = ([0, 0, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48)


def flat_numpy(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_cfg(jcfg) -> ModelConfig:
    """The same config in the port: the two ModelConfigs share fields."""
    return ModelConfig(**dataclasses.asdict(jcfg))


def port_model(params, state):
    contractor = Contractor(
        xyz_min=torch.as_tensor(np.array(state.contractor.xyz_min)),
        xyz_max=torch.as_tensor(np.array(state.contractor.xyz_max)),
        enabled=state.contractor.enabled)
    return (params_from_numpy(flat_numpy(params), device="cpu"),
            torch.as_tensor(np.array(state.active)), contractor)


def jax_model(appearance_dim=0, seed=0, num_cameras=4):
    """small_cfg model with trained-looking anchors and live level 1-2
    heads, so every decode branch and plane level carries signal."""
    jcfg = small_cfg()
    jcfg.appearance_dim = appearance_dim
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 0.5
    params, state = j_init_model(jax.random.key(0), jcfg, pts,
                                 num_cameras=num_cameras)
    a = params["anchors"]
    a["feat"] = jnp.asarray(rng.normal(size=a["feat"].shape) * 0.5,
                            jnp.float32)
    a["offsets"] = jnp.asarray(rng.normal(size=a["offsets"].shape) * 0.5,
                               jnp.float32)
    planes = params["planes"]
    for i in (1, 2):
        for head in (planes["heads"][i], planes["ctx_heads"][i]):
            head["lin"]["w"] = jnp.asarray(
                rng.normal(size=head["lin"]["w"].shape) * 0.1, jnp.float32)
    return jcfg, params, state


@pytest.mark.parametrize("level,appearance_dim",
                         [(0, 0), (2, 0), (0, 8)])
def test_render_matches_jax(level, appearance_dim):
    jcfg, params, state = jax_model(appearance_dim)
    jcam = j_look_at(*CAM, uid=2)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    jvis = j_renderer.prefilter_voxel(params["anchors"], state.active, jcam)
    want = j_renderer.render(params, state.active, state.contractor, jcam,
                             jnp.asarray(bg), visible_mask=jvis,
                             activate_level=level, is_training=False,
                             backend="pallas", **j_decode_kwargs(jcfg))

    tparams, active, contractor = port_model(params, state)
    cam = look_at_camera(*CAM, uid=2, device="cpu")
    vis = prefilter_voxel(tparams["anchors"], active, cam)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    got = render(tparams, active, contractor, cam, torch.as_tensor(bg),
                 visible_mask=vis, activate_level=level,
                 **decode_kwargs(port_cfg(jcfg)))

    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5)
    np.testing.assert_allclose(got.neural_opacity.numpy(),
                               np.asarray(want.neural_opacity),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.scaling.numpy(), np.asarray(want.scaling),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.selection_mask.numpy(),
                                  np.asarray(want.selection_mask))
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert int(got.num_clipped) == int(want.num_clipped)
    assert got.num_overflow == 0 and got.class_counts is None
    assert got.num_pairs > 0


def test_render_reproduces_golden_image():
    """tests/golden/render_golden.npz, held as test_model_render holds the
    JAX render to it."""
    g = np.load(os.path.join(REPO, "tests", "golden", "render_golden.npz"))
    jcfg = small_cfg()
    params, state = j_init_model(jax.random.key(0), jcfg, g["points"])
    tparams, active, contractor = port_model(params, state)
    cam = look_at_camera(*CAM, device="cpu")
    vis = prefilter_voxel(tparams["anchors"], active, cam)
    out = render(tparams, active, contractor, cam,
                 torch.tensor([0.1, 0.2, 0.3]), visible_mask=vis,
                 activate_level=0, **decode_kwargs(port_cfg(jcfg)))
    np.testing.assert_allclose(out.image.numpy(), g["image"], atol=3e-5)


def test_init_model_tree_matches_jax():
    """The port's random init builds the JAX tree: same paths, shapes and
    anchor state (only the random draws differ), reproducibly from a
    seed."""
    jcfg = small_cfg()
    pts = np.random.default_rng(1).normal(size=(400, 3)).astype(
        np.float32) * 0.5
    jparams, jstate = j_init_model(jax.random.key(0), jcfg, pts)
    params, state = init_model(port_cfg(jcfg), pts,
                               generator=torch.Generator().manual_seed(3),
                               device="cpu")
    again, _ = init_model(port_cfg(jcfg), pts,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu")
    want = flat_numpy(jparams)
    got = flat_numpy_torch(params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    np.testing.assert_array_equal(state.active.numpy(),
                                  np.asarray(jstate.active))
    np.testing.assert_allclose(got["['anchors']['scaling']"],
                               want["['anchors']['scaling']"], rtol=1e-5)
    for key, val in flat_numpy_torch(again).items():
        np.testing.assert_array_equal(val, got[key])
    # level >= 1 fusion heads start at zero
    assert not params["planes"]["heads"][1]["lin"]["w"].any()


def flat_numpy_torch(tree, prefix=""):
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.numpy()}
    out = {}
    for key, val in items:
        out.update(flat_numpy_torch(val, prefix + key))
    return out


def test_jax_checkpoint_renders_through_port(tmp_path):
    """A model saved by the JAX trainer's checkpointing loads through
    load_trained, and render_set writes the PNGs of the JAX render_set.  Both
    quantize by truncation, so a ~1e-7 float difference moves a pixel by
    one level only where it sits on a level boundary."""
    jcfg, params, state = jax_model(seed=4)
    model = str(tmp_path / "model")
    meta = {"contractor_min": [-1.1, -0.9, -1.0],
            "contractor_max": [1.0, 1.2, 0.9], "activate_level": 1}
    j_ckpt.save_model_checkpoint(model, 7, params, state.active, meta)

    cfg = port_cfg(jcfg)
    cfg.model_path = model
    tparams, active, contractor, level, it = load_trained(cfg, device="cpu")
    assert (level, it) == (1, 7)
    np.testing.assert_array_equal(contractor.xyz_min.numpy(),
                                  np.float32(meta["contractor_min"]))
    jparams, jactive, _ = j_ckpt.load_model_checkpoint(model, 7, params)
    want = flat_numpy(jparams)
    got = flat_numpy_torch(tparams)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))

    eyes = [[0, 0, -3.0], [2.0, 0.5, -2.0]]
    jcams = [j_look_at(e, [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48)
             for e in eyes]
    cams = [look_at_camera(e, [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48,
                           device="cpu") for e in eyes]
    jcon = j_Contractor(xyz_min=jnp.asarray(meta["contractor_min"]),
                               xyz_max=jnp.asarray(meta["contractor_max"]),
                               enabled=True)
    j_driver.render_set(str(tmp_path / "jax"), "test", 7, jcams, jparams,
                        jactive, jcon, 1, jcfg)
    fps = render_set(str(tmp_path / "port"), "test", 7, cams, tparams,
                     active, contractor, level, cfg)
    assert fps > 0
    for idx in range(len(cams)):
        name = os.path.join("test", "ours_7", "renders", f"{idx:05d}.png")
        a = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 1e-3
        assert a.std() > 0


def test_port_imports_no_jax():
    """Importing every module of splatco_torch, chip_smoke.py, the CLIs
    (render_torch.py, train_torch.py, metrics_torch.py,
    detect_popping_torch.py) and the tools (quality_run_torch.py,
    ablation_run_torch.py, finalize_quality_run_torch.py,
    profile_step_recon_torch.py, profile_torch_eval.py) pulls in neither
    jax nor splatco_tpu (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import splatco_torch, chip_smoke, render_torch, train_torch\n"
        "import metrics_torch, detect_popping_torch\n"
        "sys.path.insert(0, 'tools')\n"
        "import quality_run_torch, profile_torch_eval, ablation_run_torch\n"
        "import finalize_quality_run_torch, profile_step_recon_torch\n"
        "for m in pkgutil.walk_packages(splatco_torch.__path__,"
        " 'splatco_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules"
        " if k.split('.')[0] in ('jax', 'jaxlib', 'splatco_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


ENTRY_POINTS = {
    "init_model": lambda: init_model(
        port_cfg(small_cfg()), np.zeros((8, 3), np.float32),
        generator=torch.Generator()),
    "params_from_numpy": lambda: params_from_numpy(
        {"['a']['w']": np.zeros(3, np.float32)}),
    "look_at_camera": lambda: look_at_camera(*CAM),
    "load_trained": lambda: load_trained(port_cfg(small_cfg())),
    "load_model_checkpoint": lambda: load_model_checkpoint("unused", 1),
    "make_optimizer": lambda: make_optimizer(OptimizationConfig(), {}, 1.0,
                                             0),
    "make_train_step": lambda: make_train_step(
        port_cfg(small_cfg()), OptimizationConfig(), 2, 0, tx=None),
    "init_stats": lambda: init_stats(8, 4),
    "opt_state_from_numpy": lambda: opt_state_from_numpy({}),
    "Scene": lambda: Scene(port_cfg(small_cfg())),
    "load_camera": lambda: load_camera(
        CameraInfo(0, np.eye(3), np.zeros(3), 1.0, 1.0, "unused.png",
                   "unused", 8, 8), 0),
    "render_sets": lambda: render_sets(port_cfg(small_cfg())),
    "load_reference_model": lambda: load_reference_model(
        "unused", 1, port_cfg(small_cfg())),
    "load_train_state": lambda: load_train_state("unused", 1),
    "write_colmap_dataset": lambda: write_colmap_dataset("unused"),
    "write_blender_dataset": lambda: write_blender_dataset("unused"),
    "write_hard_dataset": lambda: write_hard_dataset("unused"),
    "hard_camera": lambda: hard_camera(0, 4, 32, 24),
    "make_contractor": lambda: make_contractor([0, 0, 0], [1, 1, 1], 1.0),
    "evaluate": lambda: evaluate(["unused"]),
    "evaluate_dir": lambda: evaluate_dir("unused"),
    "lpips.load_weights": lambda: lpips.load_weights("unused.npz"),
    "init_raft_params": lambda: init_raft_params(),
    "raft_params_from_numpy": lambda: raft_params_from_numpy({}),
    "load_raft_weights": lambda: load_raft_weights("unused.pth"),
    "make_flow_fn": lambda: make_flow_fn({}),
    "validate_popping": lambda: validate_popping("unused"),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_card_unless_cpu_asked(entry, monkeypatch):
    """Without a card, an entry point called without device="cpu" raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry]()
