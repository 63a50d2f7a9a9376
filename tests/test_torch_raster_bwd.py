"""splatco_torch's differentiable rasterize against jax.grad of
splatco_tpu's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as its own tests
do); the port runs the backward kernel's plain PyTorch version, which its
wrapper takes for CPU tensors.  Both get the same projected gaussians and
the same seeded image cotangent.

Tolerance: gradients max-normalised to 5e-4, the bound
tests/test_rasterize_pallas.py holds the Pallas backward to against the
dense oracle.  The port's serial blend and the Pallas kernel's log-depth
cumprod round differently, and the gradients amplify it through
1 / (1 - alpha).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_raster import SCENES, both_cols

from splatco_torch.ops import binning as t_bin
from splatco_torch.ops import rasterize as t_ras
from splatco_torch.ops.rasterize_cuda import raster_bwd, raster_fwd
from splatco_tpu.ops import rasterize as j_ras

TOL = 5e-4
BG = np.asarray([0.2, 0.3, 0.4], np.float32)
NAMES = ("mx", "my", "ca", "cb", "cc", "colors", "opacities", "bg")


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-8)


def cotangent(h, w, seed=2):
    return np.random.default_rng(seed).normal(size=(3, h, w)).astype(
        np.float32)


def port_inputs(tcols, colors, opac):
    """The differentiable inputs of the port's rasterize, as leaves."""
    leaves = {"mx": tcols.mx, "my": tcols.my, "ca": tcols.ca,
              "cb": tcols.cb, "cc": tcols.cc,
              "colors": torch.as_tensor(np.array(colors)),
              "opacities": torch.as_tensor(np.array(opac)),
              "bg": torch.as_tensor(BG)}
    return {k: v.clone().requires_grad_() for k, v in leaves.items()}


def port_grads(tcols, colors, opac, h, w, gimg, proxy=False):
    x = port_inputs(tcols, colors, opac)
    mx, my = x["mx"], x["my"]
    if proxy:
        x["proxy"] = torch.zeros((mx.shape[0], 2), requires_grad=True)
        mx = mx + x["proxy"][:, 0]
        my = my + x["proxy"][:, 1]
    cols = tcols._replace(mx=mx, my=my, ca=x["ca"], cb=x["cb"], cc=x["cc"])
    img = t_ras.rasterize(cols, x["colors"], x["opacities"], x["bg"], h, w)
    (img * torch.as_tensor(gimg)).sum().backward()
    return {k: v.grad.numpy() for k, v in x.items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterize_grads_match_jax(scene):
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    jcols, tcols = both_cols(proj)
    gimg = cotangent(h, w)

    def loss(mx, my, ca, cb, cc, col, op, bgv):
        c = jcols._replace(mx=mx, my=my, ca=ca, cb=cb, cc=cc)
        return jnp.sum(j_ras.rasterize(c, col, op, bgv, h, w) * gimg)

    want = jax.grad(loss, argnums=tuple(range(8)))(
        jcols.mx, jcols.my, jcols.ca, jcols.cb, jcols.cc, colors, opac,
        jnp.asarray(BG))
    got = port_grads(tcols, colors, opac, h, w, gimg)
    for name, wv in zip(NAMES, want):
        assert got[name].shape == np.asarray(wv).shape, name
        assert np.abs(np.asarray(wv)).max() > 0, name
        err = max_norm_err(got[name], wv)
        assert err < TOL, (name, err)


@pytest.mark.parametrize("scene", ["n128_64x96", "clipped"])
def test_slot_reduce_equals_float64_sum(scene):
    """The slot-map reduce of the backward equals a float64 sum of the
    per-record gradients over each gaussian's records."""
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    _, tcols = both_cols(proj)
    tiles_x, tiles_y = t_ras.tile_grid(h, w)
    tb = t_bin.bin_gaussians(tcols, torch.as_tensor(np.array(colors)),
                             torch.as_tensor(np.array(opac)), 32, tiles_x,
                             tiles_y)
    rgb, t_fin = raster_fwd(tb.records, tb.tile_start, tb.tile_end,
                            tiles_x, tiles_y, h, w)
    gpad = torch.zeros_like(rgb)
    gpad[:, :h, :w] = torch.as_tensor(cotangent(h, w))
    per_rec = raster_bwd(tb.records, tb.tile_start, tb.tile_end, tiles_x,
                         tiles_y, h, w, gpad, rgb, t_fin,
                         torch.as_tensor(BG))
    n = tcols.mx.shape[0]
    want = np.zeros((9, n))
    np.add.at(want.T, tb.gauss_id.numpy(), per_rec.numpy().T.astype(
        np.float64))
    got = t_ras.reduce_slots(per_rec, tb.slot_pos).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    # every record sits in exactly one slot
    pos = tb.slot_pos.numpy()
    assert sorted(pos[pos >= 0].tolist()) == list(range(tb.records.shape[1]))


def test_proxy_grad_is_the_mean_grad():
    """The viewspace proxy added to the means gets exactly the means'
    gradient: the screen-space gradient the densify statistics read."""
    proj, colors, opac, cam = SCENES["n128_64x96"]()
    h, w = cam.image_height, cam.image_width
    _, tcols = both_cols(proj)
    got = port_grads(tcols, colors, opac, h, w, cotangent(h, w), proxy=True)
    np.testing.assert_array_equal(got["proxy"][:, 0], got["mx"])
    np.testing.assert_array_equal(got["proxy"][:, 1], got["my"])
    assert np.abs(got["mx"]).max() > 0


def test_inference_render_unchanged_by_autograd():
    """Under inference_mode the image is bit for bit the one the
    differentiable path computes."""
    proj, colors, opac, cam = SCENES["n96_32x64"]()
    h, w = cam.image_height, cam.image_width
    _, tcols = both_cols(proj)
    args = (torch.as_tensor(np.array(colors)),
            torch.as_tensor(np.array(opac)), torch.as_tensor(BG), h, w)
    x = port_inputs(tcols, colors, opac)
    img = t_ras.rasterize(tcols._replace(mx=x["mx"]), *args)
    assert img.requires_grad
    with torch.inference_mode():
        again = t_ras.rasterize(tcols, *args)
    assert torch.equal(img.detach(), again)
