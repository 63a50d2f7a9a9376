"""train_torch.py, the port's training CLI, on the CPU: it trains a tiny
COLMAP scene in a subprocess (--device cpu), render_torch.py renders the
result, and the JAX package loads the port-trained model and renders it
as the port does (image at 3e-5, the port's render bound).  Without
--device cpu the CLI asks for the card, and raises without one.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import port_cfg

import train_torch
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.eval.render_driver import load_trained
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.utils.synthetic import write_colmap_dataset
from splatco_tpu.config import load_run_config as j_load_run_config
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models import renderer as j_renderer
from splatco_tpu.models.contraction import Contractor as j_Contractor
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs
from splatco_tpu.models.splatco import init_model as j_init_model
from splatco_tpu.train import checkpoint as j_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 10
TRAIN_ARGS = ["--feat_dim", "8", "--n_offsets", "4", "--voxel_size", "0.05",
              "--plane_size", "32", "--num_channels", "9",
              "--appearance_dim", "0", "--contractor", "--eval",
              "--iterations", str(ITERS), "--test_iterations", str(ITERS),
              "--mv", "2", "--update_from", "2", "--update_interval", "4",
              "--update_until", "9", "--start_stat", "1", "--no_downsample",
              "--seed", "1"]


def run(script, *args):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args], cwd=REPO,
        # one thread: toy shapes gain nothing from more, and the suite's
        # workers would fight over the cores
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout + res.stderr


def test_cli_trains_and_the_jax_package_renders_the_model(tmp_path):
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    write_colmap_dataset(scene, n_views=8, n_pts=150, width=64, height=48,
                         device="cpu")
    log = run("train_torch.py", "-s", scene, "-m", model, "--device", "cpu",
              *TRAIN_ARGS)
    assert "densify: +" in log and "eval test" in log
    assert os.path.exists(os.path.join(model, "point_cloud",
                                       f"iteration_{ITERS}",
                                       "point_cloud.ply"))
    run("render_torch.py", "-m", model, "--device", "cpu")
    renders = os.path.join(model, "test", f"ours_{ITERS}", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png"]
    with open(os.path.join(model, "num_gaussians.json")) as fh:
        n_anchors = json.load(fh)["model"]

    # the JAX package reads the port-trained model ...
    jcfg, _, _ = j_load_run_config(model)
    pts = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    template, _ = j_init_model(jax.random.key(0), jcfg, pts)
    jparams, jactive, meta = j_ckpt.load_model_checkpoint(model, ITERS,
                                                          template)
    assert int(jactive.sum()) == n_anchors
    contractor = j_Contractor(
        xyz_min=jnp.asarray(meta["contractor_min"], jnp.float32),
        xyz_max=jnp.asarray(meta["contractor_max"], jnp.float32),
        enabled=meta["contractor_enabled"])
    # ... and renders it as the port does
    cam_args = ([0.3, -0.4, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48)
    jcam = j_look_at(*cam_args)
    bg = jnp.ones(3) if jcfg.white_background else jnp.zeros(3)
    jvis = j_renderer.prefilter_voxel(jparams["anchors"], jactive, jcam)
    want = j_renderer.render(jparams, jactive, contractor, jcam, bg,
                             visible_mask=jvis,
                             activate_level=meta["activate_level"],
                             is_training=False, kmax=jcfg.kmax,
                             backend="pallas", **j_decode_kwargs(jcfg))
    cfg = port_cfg(jcfg)
    params, active, t_contractor, level, _ = load_trained(cfg, ITERS,
                                                          device="cpu")
    cam = look_at_camera(*cam_args, device="cpu")
    vis = prefilter_voxel(params["anchors"], active, cam)
    got = render(params, active, t_contractor, cam,
                 torch.as_tensor(np.array(bg)), visible_mask=vis,
                 activate_level=level, kmax=cfg.kmax, **decode_kwargs(cfg))
    assert level == meta["activate_level"] == 0
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5)
    assert float(got.image.std()) > 0.0


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_torch.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"),
                          *TRAIN_ARGS])
