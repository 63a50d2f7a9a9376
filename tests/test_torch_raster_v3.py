"""splatco_torch's v3 rasterizer configuration (16 px tiles,
SPLATCO_RASTER=v3) against splatco_tpu's, on the CPU: binning, blend,
rasterize and its gradients, and the switch.  The v3 step and render as
a whole are in test_torch_v3_paths.py.

The JAX side runs its v3 Pallas kernels in interpret mode, as
tests/test_raster_v3.py does; the port runs its 16 px kernels' plain
versions, which the wrappers take for CPU tensors.  Both sides get the
same projected gaussians (the JAX projection, as numpy).

Tolerances, as for the 32 px configuration: images and blend outputs at
1e-5, gradients max-normalised at 5e-4 (the bound test_raster_v3.py
holds JAX v3 to against the dense oracle).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_raster_v3 import _scene
from test_torch_raster import big_scene, both_cols
from test_torch_raster_bwd import (BG, NAMES, cotangent, max_norm_err,
                                   port_inputs)
from test_torch_render import REPO

from splatco_torch.ops import rasterize as t_ras
from splatco_torch.ops import raster_v3 as t_v3
from splatco_torch.ops.rasterize_cuda import (raster_bwd, raster_fwd,
                                              raster_fwd_plain)
from splatco_tpu.ops import raster_v3 as j_v3
from splatco_tpu.ops import rasterize as j_ras

ATOL = 1e-5
TOL = 5e-4


def v3_scene(h, w):
    proj, colors, opac, _, _ = _scene(h=h, w=w)
    return proj, colors, opac, h, w


def tied_scene(h=96, w=128):
    """Four gaussians at each of 128 centres, at one depth, with conics
    and radii of four scales: the offsets of one anchor as the model
    initialises them (equal depths in shared tiles)."""
    proj, colors, opac, _, _ = _scene(n=128, h=h, w=w, seed=7)
    scale = jnp.repeat(jnp.asarray([0.5, 1.0, 1.5, 2.5], jnp.float32)[None],
                       128, axis=0).reshape(-1)
    rep = lambda a: jnp.repeat(a, 4, axis=0)  # noqa: E731
    proj = proj._replace(
        means2d=rep(proj.means2d), depths=rep(proj.depths),
        p_view_z=rep(proj.p_view_z),
        conics=rep(proj.conics) / (scale ** 2)[:, None],
        radii=jnp.ceil(rep(proj.radii) * scale).astype(jnp.int32))
    rng = np.random.default_rng(8)
    colors = jnp.asarray(rng.uniform(size=(512, 3)), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.2, 0.99, size=(512,)), jnp.float32)
    return proj, colors, opac, h, w


# 80 x 112 is where the 16 px grid (2 x the 32 px parents: 8 x 6 tiles)
# differs from ceil(size / 16) (7 x 5); "clipped" has rects over kmax;
# "ties" has equal depths in shared tiles
SCENES = {
    "n512_96x128": lambda: v3_scene(96, 128),
    "n512_80x112": lambda: v3_scene(80, 112),
    "clipped": lambda: big_scene()[:3] + (160, 224),
    "ties": tied_scene,
}


def torch_of(a):
    return torch.as_tensor(np.array(a, np.float32))


def both_binnings(scene, kmax):
    proj, colors, opac, h, w = SCENES[scene]()
    jcols, tcols = both_cols(proj)
    n = jcols.mx.shape[0]
    tiles_x, tiles_y = t_v3.tile_grid(h, w)
    jb = j_v3.bin_gaussians_v3(jcols, colors, opac, tiles_x, tiles_y,
                               kmax=kmax, class_spec=((kmax, n),))
    tb = t_v3.bin_gaussians_v3(tcols, torch_of(colors), torch_of(opac),
                               tiles_x, tiles_y, kmax=kmax)
    return jb, tb, n, tiles_x, tiles_y, h, w


def jax_segment(jb, tiles_x, num_tiles):
    """[start, end) of each row-major 16 px tile in the JAX packing."""
    pid = np.asarray(j_v3.remap_rowmajor_to_parent(
        jnp.arange(num_tiles, dtype=jnp.int32), tiles_x, num_tiles))
    ts, te = np.asarray(jb["t_start"]), np.asarray(jb["t_end"])
    return ts[pid], te[pid]


@pytest.mark.parametrize("kmax", [16, 32])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_segments_match_jax_binning(scene, kmax):
    """Each 16 px tile holds the same gaussians, in the same depth order,
    with the same record columns, as JAX `bin_gaussians_v3` (its single
    measuring class: a packed row's gaussian is its slot key % N); the
    clip counter and max_slots agree."""
    jb, tb, n, tiles_x, tiles_y, h, w = both_binnings(scene, kmax)
    px, py = j_v3.parent_grid(h, w)
    assert (tiles_x, tiles_y) == (2 * px, 2 * py)
    num_tiles = tiles_x * tiles_y
    js, je = jax_segment(jb, tiles_x, num_tiles)
    key = np.asarray(jb["slot_key"])
    packed = np.asarray(jb["packed"])
    ts, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    for t in range(num_tiles):
        assert tb.gauss_id[ts[t]:te[t]].tolist() == \
            (key[js[t]:je[t]] % n).tolist(), t
        np.testing.assert_array_equal(tb.records[:, ts[t]:te[t]].numpy(),
                                      packed[:9, js[t]:je[t]])
    # every real pair, none of the JAX pad subtiles' slots
    assert tb.records.shape[1] == int(np.asarray(jb["t_start"])[num_tiles])
    assert int(tb.num_clipped) == int(jb["num_clipped"])
    assert int(tb.max_slots) == int(jb["max_slots"])
    if scene == "clipped":
        assert int(tb.num_clipped) > 0


def untile16(out, parents_x, parents_y, channels):
    """JAX v3 kernel output [Pn, C, 8, 128] (subtile s of a parent at
    sublanes [2s, 2s+2), 16x16 row-major) -> [C, Hp, Wp]."""
    t = np.asarray(out).reshape(parents_y, parents_x, channels, 2, 2, 16, 16)
    return t.transpose(2, 0, 3, 5, 1, 4, 6).reshape(
        channels, 32 * parents_y, 32 * parents_x)


@pytest.mark.parametrize("kmax", [16, 32])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blend_matches_pallas_forward_v3(scene, kmax):
    """rgb and T_final of the 16 px blend (plain version) against JAX
    `forward_pallas_v3` (with its empty-parent default) on the same
    scene, inside the image."""
    jb, tb, n, tiles_x, tiles_y, h, w = both_binnings(scene, kmax)
    px, py = j_v3.parent_grid(h, w)
    out = j_v3.forward_pallas_v3(jb, px * py, px)
    deflt = jnp.concatenate([jnp.zeros((px * py, 3, 8, 128)),
                             jnp.ones((px * py, 1, 8, 128))], axis=1)
    out = jnp.where(jb["parent_nonempty"][:, None, None, None], out, deflt)
    j_rgb = untile16(out[:, 0:3], px, py, 3)
    j_t = untile16(out[:, 3:4], px, py, 1)[0]
    rgb, t_fin = raster_fwd(tb.records, tb.tile_start, tb.tile_end,
                            tiles_x, tiles_y, h, w, tile=t_v3.TILE)
    assert rgb.shape == (3, 32 * py, 32 * px)
    assert t_fin.shape == (32 * py, 32 * px)
    np.testing.assert_allclose(rgb.numpy()[:, :h, :w], j_rgb[:, :h, :w],
                               atol=ATOL)
    np.testing.assert_allclose(t_fin.numpy()[:h, :w], j_t[:h, :w],
                               atol=ATOL)
    # pixels past the image edge are never blended
    assert (rgb[:, h:, :] == 0).all() and (t_fin[:, w:] == 1).all()


@pytest.mark.parametrize("kmax", [16, 32])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterize_v3_matches_jax(scene, kmax):
    proj, colors, opac, h, w = SCENES[scene]()
    jcols, tcols = both_cols(proj)
    want, jaux = j_ras.rasterize(jcols, colors, opac, jnp.asarray(BG), h, w,
                                 kmax=kmax, tile16=True, return_aux=True)
    got, aux = t_ras.rasterize(tcols, torch_of(colors), torch_of(opac),
                               torch.as_tensor(BG), h, w, kmax=kmax,
                               tile16=True, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert int(aux["num_clipped"]) == int(jaux["num_clipped"])
    assert int(aux["max_slots"]) == int(jaux["max_slots"])
    assert aux["num_overflow"] == 0 and aux["num_pairs"] > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterize_v3_grads_match_jax(scene):
    proj, colors, opac, h, w = SCENES[scene]()
    jcols, tcols = both_cols(proj)
    gimg = cotangent(h, w)

    def loss(mx, my, ca, cb, cc, col, op, bgv):
        c = jcols._replace(mx=mx, my=my, ca=ca, cb=cb, cc=cc)
        return jnp.sum(j_ras.rasterize(c, col, op, bgv, h, w, kmax=32,
                                       tile16=True) * gimg)

    want = jax.grad(loss, argnums=tuple(range(8)))(
        jcols.mx, jcols.my, jcols.ca, jcols.cb, jcols.cc, colors, opac,
        jnp.asarray(BG))
    x = port_inputs(tcols, colors, opac)
    cols = tcols._replace(mx=x["mx"], my=x["my"], ca=x["ca"], cb=x["cb"],
                          cc=x["cc"])
    img = t_ras.rasterize(cols, x["colors"], x["opacities"], x["bg"], h, w,
                          kmax=32, tile16=True)
    (img * torch.as_tensor(gimg)).sum().backward()
    for name, wv in zip(NAMES, want):
        got = x[name].grad.numpy()
        assert got.shape == np.asarray(wv).shape, name
        assert np.abs(np.asarray(wv)).max() > 0, name
        err = max_norm_err(got, wv)
        assert err < TOL, (name, err)


def test_v3_slot_reduce_equals_float64_sum():
    """The backward's per-record gradients, reduced per gaussian through
    the 16 px binning's slot map, equal a float64 sum over each
    gaussian's records."""
    _, tb, n, tiles_x, tiles_y, h, w = both_binnings("clipped", 16)
    args = (tb.records, tb.tile_start, tb.tile_end, tiles_x, tiles_y, h, w)
    rgb, t_fin = raster_fwd(*args, tile=t_v3.TILE)
    gpad = torch.zeros_like(rgb)
    gpad[:, :h, :w] = torch.as_tensor(cotangent(h, w))
    per_rec = raster_bwd(*args, gpad, rgb, t_fin, torch.as_tensor(BG),
                         tile=t_v3.TILE)
    want = np.zeros((9, n))
    np.add.at(want.T, tb.gauss_id.numpy(),
              per_rec.numpy().T.astype(np.float64))
    got = t_ras.reduce_slots(per_rec, tb.slot_pos).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_v3_plain_counts_work():
    """The work counters behind the 16 px kernels' bounds."""
    _, tb, _, tiles_x, tiles_y, h, w = both_binnings("n512_96x128", 32)
    work = {}
    raster_fwd_plain(tb.records, tb.tile_start, tb.tile_end, tiles_x,
                     tiles_y, h, w, work=work, tile=t_v3.TILE)
    assert 0 < int(work["contribs"]) <= int(work["evals"])
    assert int(work["evals"]) <= tb.records.shape[1] * 256


@pytest.mark.parametrize("value,want", [("v3", True), ("v2", False),
                                        (None, False)])
def test_env_switch_sets_default(value, want):
    """SPLATCO_RASTER=v3 at import selects the 16 px configuration, as in
    the JAX package (fresh interpreter)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SPLATCO_RASTER", None)
    if value is not None:
        env["SPLATCO_RASTER"] = value
    code = ("import splatco_torch.ops.rasterize as r\n"
            "print(r.TILE16_DEFAULT)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(want)
