"""The v3 rasterizer configuration (16 px tiles) on splatco_torch's
training and render paths as a whole, against splatco_tpu's, on the
CPU: whole SVC steps (tests/test_train_step.py's toy model at 48x64 and
at 80x112, where the 16 px grid is wider than ceil(size / 16)) and the
render of a small model.

The JAX package's v3 switch is its module attribute `TILE16_DEFAULT`,
read when `rasterize` is called (traced), so the JAX side sets it with
monkeypatch; the port passes `tile16=True`.  The JAX side runs its
Pallas kernels in interpret mode, the port its kernels' plain versions.

Tolerances, as for the 32 px configuration (test_torch_train_step.py,
test_torch_render.py): loss and l1 at 1e-5 relative, con at 1e-4, the
statistics' counts exactly, step-2 params max-normalised at 1e-3, the
render at 3e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses_optim import flat_numpy, flat_torch
from test_torch_render import CAM, jax_model, port_cfg, port_model
from test_torch_train_step import (check_metrics, check_stats, jax_steps,
                                   port_step)
from test_train_step import build_toy

from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models import renderer as j_renderer
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs
from splatco_tpu.ops import rasterize as j_ras


def step_case(h, w):
    """tests/test_train_step.py's toy model and cameras at h x w, with
    constant targets."""
    cfg, params, state, _, _ = build_toy()
    cam_args = [(eye, 1.0, 1.0 * h / w, w, h)
                for eye in ([0, 0, -3], [0.5, 0.3, -2.8])]
    gts = (jnp.full((3, h, w), 0.6), jnp.full((3, h, w), 0.4))
    return cfg, params, state, cam_args, gts


@pytest.fixture(scope="module", params=["48x64", "80x112"])
def v3_runs(request):
    """Two JAX SVC steps in v3 (the switch set while they are traced) and
    the port's v3 step from the JAX state before each."""
    h, w = map(int, request.param.split("x"))
    case = step_case(h, w)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ras, "TILE16_DEFAULT", True)
        jx = jax_steps(case, 2)
    return {"jax": jx,
            "port1": port_step(case, *jx[0], tile16=True),
            "port2": port_step(case, *jx[1][:3], tile16=True)}


@pytest.mark.parametrize("step", [1, 2])
def test_v3_step_metrics_match_jax(v3_runs, step):
    check_metrics(v3_runs[f"port{step}"][3], v3_runs["jax"][step][3])


@pytest.mark.parametrize("step", [1, 2])
def test_v3_step_stats_match_jax(v3_runs, step):
    check_stats(v3_runs[f"port{step}"][2], v3_runs["jax"][step][2])


def test_v3_step2_params_match_jax(v3_runs):
    got = flat_torch(v3_runs["port2"][0])
    want = flat_numpy(v3_runs["jax"][2][0])
    assert sorted(got) == sorted(want)
    for key in want:
        g = got[key].numpy().astype(np.float64)
        wv = want[key].astype(np.float64)
        err = np.abs(g - wv).max() / (np.abs(wv).max() + 1e-12)
        assert err < 1e-3, (key, err)


@pytest.mark.parametrize("level", [0, 2])
def test_render_v3_matches_jax(level, monkeypatch):
    jcfg, params, state = jax_model()
    jcam = j_look_at(*CAM, uid=2)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    monkeypatch.setattr(j_ras, "TILE16_DEFAULT", True)
    jvis = j_renderer.prefilter_voxel(params["anchors"], state.active, jcam)
    want = j_renderer.render(params, state.active, state.contractor, jcam,
                             jnp.asarray(bg), visible_mask=jvis,
                             activate_level=level, is_training=False,
                             backend="pallas", **j_decode_kwargs(jcfg))
    tparams, active, contractor = port_model(params, state)
    cam = look_at_camera(*CAM, uid=2, device="cpu")
    vis = prefilter_voxel(tparams["anchors"], active, cam)
    got = render(tparams, active, contractor, cam, torch.as_tensor(bg),
                 visible_mask=vis, activate_level=level, tile16=True,
                 **decode_kwargs(port_cfg(jcfg)))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5)
    assert int(got.num_clipped) == int(want.num_clipped)
    assert int(got.max_slots) == int(want.max_slots)
    # the 32 px render of the same model differs: v3 is its own path
    v2 = render(tparams, active, contractor, cam, torch.as_tensor(bg),
                visible_mask=vis, activate_level=level, tile16=False,
                **decode_kwargs(port_cfg(jcfg)))
    assert got.num_pairs != v2.num_pairs
