"""splatco_torch binning + blend against splatco_tpu's, on the CPU.

The JAX side runs its Pallas forward kernel in interpret mode (as its own
tests do); the port runs the blend kernel's plain PyTorch version, which
is what its wrapper takes for CPU tensors.  Both sides get the same
projected gaussians (the JAX projection, as numpy), so binning decisions
see identical inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rasterize_pallas import make_scene

from splatco_torch.ops import binning as t_bin
from splatco_torch.ops import rasterize as t_ras
from splatco_torch.ops.projection import ProjectedCols as TCols
from splatco_torch.ops.rasterize_cuda import raster_fwd, raster_fwd_plain
from splatco_tpu.ops import binning as j_bin
from splatco_tpu.ops import rasterize as j_ras
from splatco_tpu.ops import rasterize_pallas as rp
from splatco_tpu.ops.projection import cols_of

ATOL = 1e-5  # the bound test_pallas_forward_matches_oracle holds Pallas to


def big_scene(n=64, seed=5, h=160, w=224):
    """Gaussians large enough on screen that some rects exceed kmax."""
    rng = np.random.default_rng(seed)
    proj, colors, opac, cam = make_scene(n=n, seed=seed, h=h, w=w)
    scale = jnp.asarray(rng.uniform(0.5, 6.0, size=(n,)), jnp.float32)
    conics = proj.conics / (scale ** 2)[:, None]
    radii = jnp.ceil(proj.radii * scale).astype(jnp.int32)
    return proj._replace(conics=conics, radii=radii), colors, opac, cam


SCENES = {
    "n128_64x96": lambda: make_scene(),
    "n96_32x64": lambda: make_scene(n=96, seed=1, h=32, w=64),
    "n96_seed3": lambda: make_scene(n=96, seed=3, h=32, w=64),
    "clipped": lambda: big_scene(),
}


def both_cols(proj):
    jcols = cols_of(proj)
    tcols = TCols(*(torch.as_tensor(np.array(c, np.float32)) for c in jcols))
    return jcols, tcols


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_segments_match_jax_binning(scene):
    """Each tile holds the same gaussians in the same depth order, and the
    clip counters agree."""
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    tiles_x, tiles_y = j_ras._tiles(h, w)
    jcols, tcols = both_cols(proj)
    n = jcols.mx.shape[0]
    jb = j_bin.bin_gaussians(jcols, colors, opac, 32, tiles_x, tiles_y,
                             kmax=12, chunk=rp.CHUNK)
    tb = t_bin.bin_gaussians(tcols, torch.as_tensor(np.array(colors)),
                             torch.as_tensor(np.array(opac)), 32, tiles_x,
                             tiles_y, kmax=12)
    gid = np.asarray(jb.slot_key) % n
    js, je = np.asarray(jb.tile_start), np.asarray(jb.tile_end)
    ts, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    for tile in range(tiles_x * tiles_y):
        assert gid[js[tile]:je[tile]].tolist() == \
            tb.gauss_id[ts[tile]:te[tile]].tolist(), tile
    assert int(tb.num_clipped) == int(jb.num_clipped)
    assert int(tb.max_slots) == int(jb.max_slots)
    assert tb.records.shape == (9, int(js[-1]))
    if scene == "clipped":
        assert int(tb.num_clipped) > 0
    # records are the gathered columns of the gaussian they name
    g = tb.gauss_id.numpy()
    np.testing.assert_array_equal(tb.records[0].numpy(),
                                  np.asarray(jcols.mx)[g])
    np.testing.assert_array_equal(tb.records[8].numpy(),
                                  np.asarray(colors)[g, 2])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blend_matches_pallas_forward(scene):
    """rgb and T_final of the blend (plain version) against the Pallas
    forward kernel on the JAX binning of the same scene."""
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    tiles_x, tiles_y = j_ras._tiles(h, w)
    jcols, tcols = both_cols(proj)
    n = jcols.mx.shape[0]
    jb = j_bin.bin_gaussians(jcols, colors, opac, 32, tiles_x, tiles_y,
                             kmax=12, chunk=rp.CHUNK)
    out = rp.forward_pallas(jb, tiles_x * tiles_y, tiles_x,
                            j_bin.meta_block_bits(n, 12, rp.CHUNK))
    j_rgb = np.asarray(j_ras._untile(out[:, 0:3], tiles_y, tiles_x, 3))
    j_t = np.asarray(j_ras._untile(out[:, 3:4], tiles_y, tiles_x, 1))[0]
    tb = t_bin.bin_gaussians(tcols, torch.as_tensor(np.array(colors)),
                             torch.as_tensor(np.array(opac)), 32, tiles_x,
                             tiles_y, kmax=12)
    rgb, t_fin = raster_fwd(tb.records, tb.tile_start, tb.tile_end, tiles_x,
                            tiles_y, h, w)
    assert rgb.shape == (3, tiles_y * 32, tiles_x * 32)
    np.testing.assert_allclose(rgb.numpy()[:, :h, :w], j_rgb[:, :h, :w],
                               atol=ATOL)
    np.testing.assert_allclose(t_fin.numpy()[:h, :w], j_t[:h, :w], atol=ATOL)
    # pixels past the image edge are never blended
    assert (rgb[:, h:, :] == 0).all() and (t_fin[:, w:] == 1).all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterize_matches_jax(scene):
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    jcols, tcols = both_cols(proj)
    want, jaux = j_ras.rasterize(jcols, colors, opac, jnp.asarray(bg), h, w,
                                 return_aux=True)
    got, aux = t_ras.rasterize(tcols, torch.as_tensor(np.array(colors)),
                               torch.as_tensor(np.array(opac)),
                               torch.as_tensor(bg), h, w, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert int(aux["num_clipped"]) == int(jaux["num_clipped"])
    assert aux["num_overflow"] == 0
    assert aux["num_pairs"] > 0


def test_blend_plain_counts_work():
    """The work counters that feed the kernel's bound: every contribution
    is an evaluation, and no pixel evaluates more than its tile's
    records."""
    proj, colors, opac, cam = make_scene()
    _, tcols = both_cols(proj)
    tiles_x, tiles_y = j_ras._tiles(cam.image_height, cam.image_width)
    tb = t_bin.bin_gaussians(tcols, torch.as_tensor(np.array(colors)),
                             torch.as_tensor(np.array(opac)), 32, tiles_x,
                             tiles_y)
    work = {}
    raster_fwd_plain(tb.records, tb.tile_start, tb.tile_end, tiles_x,
                     tiles_y, cam.image_height, cam.image_width, work=work)
    assert 0 < int(work["contribs"]) <= int(work["evals"])
    assert int(work["evals"]) <= tb.records.shape[1] * 1024
