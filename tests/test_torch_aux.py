"""The port's remaining library functions against splatco_tpu on the CPU:
the entropy models (ops/entropy.py), eval_sh, the math helpers, the AoS
projection and tile rects, decontract, fake_quantize, resize_plane,
load_pytree_like and trainable_fields.

Inputs are seeded numpy arrays handed to both packages.  Tolerances:
elementwise float32 arithmetic in the same order is held exactly or to
1e-6; where a matmul, an erf/log or a reduction rounds in another order,
to 1e-5 relative / 1e-5 absolute (a few float32 ulps of the sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.data import cameras as t_cam
from splatco_torch.models import anchors as t_anchors
from splatco_torch.models import contraction as t_con
from splatco_torch.models import triplane as t_tri
from splatco_torch.ops import binning as t_bin
from splatco_torch.ops import entropy as t_ent
from splatco_torch.ops import projection as t_proj
from splatco_torch.ops import sh as t_sh
from splatco_torch.train import checkpoint as t_ckpt
from splatco_torch.utils import math as t_math
from splatco_tpu.data import cameras as j_cam
from splatco_tpu.models import anchors as j_anchors
from splatco_tpu.models import contraction as j_con
from splatco_tpu.models import triplane as j_tri
from splatco_tpu.ops import entropy as j_ent
from splatco_tpu.ops import projection as j_proj
from splatco_tpu.ops import sh as j_sh
from splatco_tpu.train import checkpoint as j_ckpt
from splatco_tpu.utils import math as j_math

RTOL = ATOL = 1e-5


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- entropy

def bits_close(got, want, bits):
    """|got - want| <= (1e-5 + 4 * 2^-24 / P) |want| + 1e-5 with
    P = 2^-bits: P is a difference of two CDF values that cancels where
    both near 1, and the libraries' CDFs agree to a few ulps of 1, so P
    carries ~4 * 2^-24 absolute error; the bits and the gradients (which
    divide by P) carry it relative to P."""
    got, want = np.asarray(got), np.asarray(want)
    rel = 1e-5 + 4 * 2.0 ** -24 / 2.0 ** -np.asarray(bits)
    assert np.all(np.abs(got - want) <= rel * np.abs(want) + 1e-5)


def test_gaussian_bits_and_grads_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=64).astype(np.float32) * 3
    mean = rng.normal(size=64).astype(np.float32)
    scale = rng.uniform(-2, 2, size=64).astype(np.float32)
    scale[:4] = 0.0  # |scale| under the bound
    want = np.asarray(j_ent.gaussian_bits(x, mean, scale, 0.5))
    gw = jax.grad(lambda s, m: j_ent.gaussian_bits(x, m, s, 0.5).sum(),
                  argnums=(0, 1))(scale, mean)
    s_t, m_t = t(scale).requires_grad_(), t(mean).requires_grad_()
    got = t_ent.gaussian_bits(t(x), m_t, s_t, 0.5)
    got.sum().backward()
    bits_close(got.detach(), want, want)
    bits_close(s_t.grad, gw[0], want)
    bits_close(m_t.grad, gw[1], want)


def test_low_bound_gates_the_gradient():
    """The gradient passes where x >= 1e-6 or where it pushes x up
    (g < 0), and is zero below the bound for g > 0, as JAX's VJP."""
    x = np.array([1e-8, 1e-8, 1.0, 1.0, 1e-6], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 2.0], np.float32)
    want = jax.vjp(j_ent.low_bound, jnp.asarray(x))[1](jnp.asarray(g))[0]
    xt = t(x).requires_grad_()
    y = t_ent.low_bound(xt)
    y.backward(t(g))
    np.testing.assert_array_equal(y.detach(), np.maximum(x, 1e-6))
    np.testing.assert_array_equal(xt.grad, want)
    np.testing.assert_array_equal(xt.grad, [0.0, -1.0, 1.0, -1.0, 2.0])


def test_universe_quant_dither_and_straight_through():
    x = torch.linspace(-2, 2, 257, requires_grad=True)
    y = t_ent.universe_quant(torch.Generator().manual_seed(0), x)
    d = (y - x).detach()
    assert float(d.abs().max()) <= 0.5
    # round(x + u) - u - x is the rounding error of x + u: an integer
    # minus (x + u), so y + u lands on integers
    y.sum().backward()
    np.testing.assert_array_equal(x.grad, np.ones(257, np.float32))
    again = t_ent.universe_quant(torch.Generator().manual_seed(0), x)
    assert torch.equal(again, y)
    # JAX's draws differ, but its bound is the same
    yj = j_ent.universe_quant(jax.random.key(0), jnp.asarray(x.detach()))
    assert float(jnp.abs(yj - jnp.asarray(x.detach())).max()) <= 0.5


def test_factorized_model_matches_jax():
    jp = j_ent.init_factorized(jax.random.key(0), channels=4)
    tp = t_ent.factorized_from_numpy(jax.tree.map(np.asarray, jp))
    ours = t_ent.init_factorized(torch.Generator().manual_seed(0), 4)
    for k in ("matrices", "biases", "factors"):
        assert [tuple(a.shape) for a in ours[k]] == \
            [tuple(a.shape) for a in tp[k]]
    for a, b in zip(ours["matrices"], tp["matrices"]):
        # the same constant, rounded once here and through float32
        # log(expm1) in JAX: an ulp apart
        close(a, b, rtol=1e-6, atol=0)
    assert all(float(b.abs().max()) <= 0.5 for b in ours["biases"])
    x = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    want = j_ent.factorized_bits(jp, jnp.asarray(x))
    got = t_ent.factorized_bits(tp, t(x))
    bits_close(got.detach(), want, want)
    assert got.shape == (16, 4) and bool((got >= 0).all())
    # the gradients divide differences of nearly equal sigmoids (and of
    # their slopes) by P, which float32 cannot resolve here: both sides
    # are compared in float64, to 1e-9 relative of each leaf's max
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        gw = jax.grad(lambda p: j_ent.factorized_bits(
            p, jnp.asarray(x, jnp.float64)).sum())(jp64)
        gw = jax.tree.map(np.asarray, gw)
    tp64 = {k: [a.detach().double().requires_grad_() for a in v]
            for k, v in tp.items()}
    t_ent.factorized_bits(tp64, t(x).double()).sum().backward()
    for k in ("matrices", "biases", "factors"):
        for a, g in zip(tp64[k], gw[k]):
            assert a.grad.dtype == torch.float64
            close(a.grad, g, rtol=0, atol=1e-9 * np.abs(g).max())


# --------------------------------------------------------------- eval_sh

@pytest.mark.parametrize("deg", range(5))
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, (deg + 1) ** 2 + 1)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = j_sh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    got = t_sh.eval_sh(deg, t(sh), t(d))
    assert got.shape == (50, 3)
    close(got, want, atol=1e-5)


def test_eval_sh_rejects_bad_degrees():
    with pytest.raises(ValueError):
        t_sh.eval_sh(5, torch.zeros(1, 36), torch.zeros(1, 3))
    with pytest.raises(ValueError):
        t_sh.eval_sh(2, torch.zeros(1, 4), torch.zeros(1, 3))


# ------------------------------------------------------------------ math

def test_math_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = np.exp(rng.normal(size=(40, 3))).astype(np.float32)
    close(t_math.quat_to_rotmat(t(q)), j_math.quat_to_rotmat(q), atol=1e-6)
    cov = t_math.build_covariance(t(s), t(q))
    close(cov, j_math.build_covariance(jnp.asarray(s), jnp.asarray(q)))
    six = t_math.strip_symmetric(cov)
    np.testing.assert_array_equal(
        six, j_math.strip_symmetric(jnp.asarray(cov.numpy())))
    np.testing.assert_array_equal(t_math.unstrip_symmetric(six), cov)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    for arr in (a, t(a)):
        got = t_math.pad_to(arr, 8, axis=0, value=-1)
        np.testing.assert_array_equal(
            np.asarray(got), j_math.pad_to(a, 8, axis=0, value=-1))
        assert type(got) is type(arr)
    assert t_math.pad_to(t(a), 5) is not None
    with pytest.raises(ValueError):
        t_math.pad_to(a, 4)


# ------------------------------------------------------------ projection

CAMERAS = [
    ([0, 0, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48),
    ([2.5, 0.4, -1.0], [0.1, 0, 0.2], [0, -1, 0], 1.2, 0.9, 96, 64),
]


def scene(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:5, 2] = -2.9  # at the near plane of camera 0
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.5).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return pts, s, q


@pytest.mark.parametrize("ci", range(len(CAMERAS)))
def test_aos_projection_matches_jax_and_the_columns(ci):
    pts, s, q = scene(ci)
    jc = j_cam.look_at_camera(*CAMERAS[ci])
    tc = t_cam.look_at_camera(*CAMERAS[ci], device="cpu")
    jcov = j_math.build_covariance(jnp.asarray(s), jnp.asarray(q))
    want = j_proj.project_from_camera(jnp.asarray(pts), jcov, jc)
    got = t_proj.project_from_camera(
        t(pts), t_math.build_covariance(t(s), t(q)), tc)
    valid = np.asarray(want.radii) > 0
    assert valid.sum() > 100
    np.testing.assert_array_equal(got.radii, want.radii)
    close(got.means2d, want.means2d, rtol=1e-5, atol=1e-3)
    close(got.depths, want.depths)
    close(got.conics[valid], np.asarray(want.conics)[valid], rtol=1e-4,
          atol=1e-6)
    # the AoS path against the port's columnwise one, through cols_of
    cols = t_proj.project_gaussians_cols(t(pts), t(s), t(q), tc)
    aos = t_proj.cols_of(got)
    np.testing.assert_array_equal(aos.radius, cols.radius)
    close(aos.mx, cols.mx, atol=1e-3)
    close(aos.ca[valid], cols.ca[valid], rtol=1e-4, atol=1e-6)
    back = t_proj.aos_of(cols)
    assert torch.equal(t_proj.cols_of(back).mx, cols.mx)
    assert torch.equal(back.radii, cols.radius.to(torch.int32))


def test_tile_rect_matches_jax_and_the_binning():
    """The rects of tile_rect are JAX's, and those the binning starts
    from before it clips to kmax (a kmax no rect exceeds)."""
    rng = np.random.default_rng(3)
    n = 500
    m2d = rng.uniform(-80, 400, size=(n, 2)).astype(np.float32)
    radii = rng.integers(0, 90, size=n).astype(np.int32)
    want = j_proj.tile_rect(jnp.asarray(m2d), jnp.asarray(radii), 32, 10, 7)
    got = t_proj.tile_rect(t(m2d), t(radii), 32, 10, 7)
    np.testing.assert_array_equal(got, want)
    x0, y0, sx, counts, clipped = t_bin._rects(
        t(m2d[:, 0]), t(m2d[:, 1]), t(radii).float(), 32, 10, 7, 70)
    assert not bool(clipped.any())
    live = radii > 0
    np.testing.assert_array_equal(x0[live], got[live, 0])
    np.testing.assert_array_equal(y0[live], got[live, 1])
    np.testing.assert_array_equal(sx[live],
                                  (got[live, 2] - got[live, 0]).clamp_min(0))
    span = ((got[:, 2] - got[:, 0]).clamp_min(0)
            * (got[:, 3] - got[:, 1]).clamp_min(0))
    np.testing.assert_array_equal(counts[live], span[live])


# ------------------------------------------------------ models and i/o

def test_decontract_inverts_contract_and_matches_jax():
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(200, 3)) * 3).astype(np.float32)
    center, length = [0.2, -0.1, 0.3], [2.0, 3.0, 1.5]
    tc = t_con.make_contractor(center, length, 1.0, device="cpu")
    jc = j_con.make_contractor(center, length, 1.0)
    c = t_con.contract(tc, t(xyz))
    back = t_con.decontract(tc, c)
    close(back, xyz, rtol=1e-4, atol=1e-4)
    close(back, j_con.decontract(jc, jnp.asarray(c.numpy())), atol=1e-6)


def test_fake_quantize_matches_jax():
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32) * 4
    for bits in (8, 12):
        np.testing.assert_array_equal(
            t_tri.fake_quantize(t(x), bits), j_tri.fake_quantize(x, bits))


@pytest.mark.parametrize("hw", [(32, 24), (40, 20), (8, 6), (5, 30),
                                (16, 12)])
def test_resize_plane_matches_jax_both_ways(hw):
    """jax.image.resize's linear resize antialiases where it shrinks:
    F.interpolate with antialias=True matches it up and down (plain
    bilinear only up)."""
    p = np.random.default_rng(0).normal(size=(3, 16, 12)).astype(np.float32)
    want = j_tri.resize_plane(jnp.asarray(p), hw)
    got = t_tri.resize_plane(t(p), hw)
    assert got.shape == (3,) + hw
    close(got, want, atol=2e-6)


def test_load_pytree_like_reads_the_jax_archive(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "b": [np.arange(5, dtype=np.int32),
                  rng.normal(size=2).astype(np.float32)]}
    j_ckpt.save_pytree(str(tmp_path / "x.npz"), jax.tree.map(jnp.asarray,
                                                             tree))
    template = {"a": {"w": torch.zeros(3, 4)},
                "b": [torch.zeros(5, dtype=torch.int64), torch.zeros(2)]}
    got = t_ckpt.load_pytree_like(str(tmp_path / "x.npz"), template)
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    assert got["b"][0].dtype == torch.int64
    np.testing.assert_array_equal(got["b"][0], tree["b"][0])
    assert isinstance(got["b"], list)
    # and the JAX loader reads what the port saved
    t_ckpt.save_pytree(str(tmp_path / "y.npz"), got)
    back = j_ckpt.load_pytree_like(str(tmp_path / "y.npz"),
                                   jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(back["b"][1], tree["b"][1])
    with pytest.raises(ValueError):
        t_ckpt.load_pytree_like(str(tmp_path / "x.npz"),
                                {"a": {"w": torch.zeros(4, 3)}})
    with pytest.raises(KeyError):
        t_ckpt.load_pytree_like(str(tmp_path / "x.npz"), {"c": torch.zeros(1)})


def test_trainable_fields_match_jax():
    assert t_anchors.trainable_fields() == j_anchors.trainable_fields()
