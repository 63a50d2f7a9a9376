"""The `use_spatial_ctx` path of splatco_torch (models/context_grid.py)
against splatco_tpu, on the CPU: each context-grid level, and a whole
render with `use_spatial_ctx=True` (image and gradients).

Tolerances: the context features at 1e-5 against JAX's function run op
by op (`spatial_ctx.__wrapped__`; the port agrees with it to the last
bit here).  Compiled with jit, XLA contracts `pos - floor(pos)` with the
product that makes `pos` into one fused multiply-add, which moves the
interpolation weights by up to an ulp of (resolution - 1), ~3e-5 at
level 0's 300^2 grids: the jitted function differs from the unjitted one
by up to ~1e-4, more than the port does.  The image at 3e-5, the bound
of the port's other render tests; the gradient of a seeded image loss
with respect to every parameter leaf at 5e-4 of that leaf's largest
|value| (the rasterizer's gradient bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import CAM, port_cfg, port_model
from test_model_render import small_cfg

from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models import context_grid as t_ctx
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.train.optimizer import tree_leaves
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models import context_grid as j_ctx
from splatco_tpu.models import renderer as j_renderer
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs
from splatco_tpu.models.splatco import init_model as j_init_model


@pytest.mark.parametrize("level", [0, 1, 2])
def test_spatial_ctx_matches_jax(level):
    rng = np.random.default_rng(level)
    xyz = rng.uniform(-2.2, 2.2, size=(3000, 3)).astype(np.float32)
    feats = rng.normal(size=(3000, 8)).astype(np.float32)
    mask = rng.uniform(size=3000) < 0.8
    want = np.asarray(j_ctx.spatial_ctx.__wrapped__(
        jnp.asarray(xyz), jnp.asarray(feats), -2.0, 2.0, level=level,
        mask=jnp.asarray(mask)))
    got = t_ctx.spatial_ctx(torch.as_tensor(xyz), torch.as_tensor(feats),
                            -2.0, 2.0, level=level,
                            mask=torch.as_tensor(mask)).numpy()
    assert got.shape == (3000, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def spatial_model():
    jcfg = small_cfg()
    jcfg.use_spatial_ctx = True
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(400, 3)).astype(np.float32) * 0.5
    params, state = j_init_model(jax.random.key(0), jcfg, pts)
    a = params["anchors"]
    # off the voxel lattice: a voxel-snapped anchor at the contraction
    # box's edge (|x| = 0.8 here) sits exactly on a node of every context
    # grid, where the interpolation's gradient jumps and either one-sided
    # value is right (JAX's fused multiply-add picks one, the port the
    # other)
    a["anchor"] = a["anchor"] + jnp.asarray(
        rng.uniform(-0.01, 0.01, size=a["anchor"].shape), jnp.float32)
    a["feat"] = jnp.asarray(rng.normal(size=a["feat"].shape) * 0.5,
                            jnp.float32)
    a["offsets"] = jnp.asarray(rng.normal(size=a["offsets"].shape) * 0.5,
                               jnp.float32)
    for i in (1, 2):
        for head in (params["planes"]["heads"][i],
                     params["planes"]["ctx_heads"][i]):
            head["lin"]["w"] = jnp.asarray(
                rng.normal(size=head["lin"]["w"].shape) * 0.1, jnp.float32)
    return jcfg, params, state


def test_render_with_spatial_ctx_matches_jax():
    jcfg, params, state = spatial_model()
    assert params["planes"]["ctx_heads"][0]["lin"]["w"].shape[0] == 64
    level = 2
    jcam = j_look_at(*CAM, uid=0)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    cot = np.random.default_rng(4).normal(size=(3, 48, 64)).astype(
        np.float32)
    jvis = j_renderer.prefilter_voxel(params["anchors"], state.active, jcam)

    def j_loss(p):
        out = j_renderer.render(p, state.active, state.contractor, jcam,
                                jnp.asarray(bg), visible_mask=jvis,
                                activate_level=level, is_training=False,
                                backend="pallas", **j_decode_kwargs(jcfg))
        return jnp.sum(out.image * cot), out.image

    (_, want_img), want_grads = jax.value_and_grad(j_loss, has_aux=True)(
        params)

    tparams, active, contractor = port_model(params, state)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    cam = look_at_camera(*CAM, uid=0, device="cpu")
    vis = prefilter_voxel(tparams["anchors"], active, cam)
    img = render(tparams, active, contractor, cam, torch.as_tensor(bg),
                 visible_mask=vis, activate_level=level,
                 **decode_kwargs(port_cfg(jcfg))).image
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want_img),
                               atol=3e-5)
    grads = torch.autograd.grad((img * torch.as_tensor(cot)).sum(), leaves,
                                allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(want_grads)
    assert len(jleaves) == len(grads)
    checked = 0
    for want, got in zip(jleaves, grads):
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = np.abs(want).max()
        if scale == 0.0:
            assert not got.any()
            continue
        assert np.abs(got - want).max() <= 5e-4 * scale
        checked += 1
    # the anchor features reach the image through the context grids too
    feat_grad = np.asarray(want_grads["anchors"]["feat"])
    assert np.abs(feat_grad).max() > 0 and checked > 20
