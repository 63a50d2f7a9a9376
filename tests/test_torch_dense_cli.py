"""`--backend dense` on the port's CLIs, on the CPU: train_torch.py trains
a tiny COLMAP scene with the dense compositor, render_torch.py renders the
model with it, and the test view's PNG equals the kernel path's render of
the same model within one level (no tile rect clips at 64x48, so the two
blends agree to rounding).
"""
import os
import subprocess
import sys

import numpy as np
import torch
from test_torch_train_cli import ITERS, TRAIN_ARGS

from splatco_torch.config import load_run_config
from splatco_torch.data.images import decode_png
from splatco_torch.data.scene import Scene
from splatco_torch.eval.render_driver import load_trained
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.utils.synthetic import write_colmap_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(script, *args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPLATCO_")}
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args], cwd=REPO,
        env=dict(env, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout + res.stderr


def test_clis_train_and_render_with_the_dense_backend(tmp_path):
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    write_colmap_dataset(scene, n_views=8, n_pts=150, width=64, height=48,
                         device="cpu")
    log = run("train_torch.py", "-s", scene, "-m", model, "--device", "cpu",
              "--backend", "dense", *TRAIN_ARGS)
    assert "'backend': 'dense'" in log and "eval test" in log
    run("render_torch.py", "-m", model, "--device", "cpu", "--backend",
        "dense")
    png = os.path.join(model, "test", f"ours_{ITERS}", "renders",
                       "00000.png")
    got = decode_png(png)  # [H, W, 3] uint8

    cfg, _, _ = load_run_config(model)
    params, active, contractor, level, _ = load_trained(cfg, ITERS,
                                                        device="cpu")
    cam = Scene(cfg, shuffle=False, write_artifacts=False,
                device="cpu").test_cameras()[0]
    bg = torch.ones(3) if cfg.white_background else torch.zeros(3)
    with torch.no_grad():
        want = render(params, active, contractor, cam, bg,
                      visible_mask=prefilter_voxel(params["anchors"], active,
                                                   cam),
                      activate_level=level, kmax=cfg.kmax,
                      **decode_kwargs(cfg))
    assert int(want.num_clipped) == 0
    # the PNG writer's truncating quantization
    want8 = (want.image.clamp(0.0, 1.0).numpy().transpose(1, 2, 0)
             * 255).astype(np.uint8)
    assert got.shape == want8.shape
    assert np.abs(got.astype(np.int16) - want8).max() <= 1
    assert float(want.image.std()) > 0.0
