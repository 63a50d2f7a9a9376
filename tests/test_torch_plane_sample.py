"""The tri-plane sampler (splatco_torch/ops/plane_sample.py) on the CPU:
its plain forward and backward against JAX's `_sample_plane` and
`jax.vjp` of it, the backward's exact integer sums (independent of the
rows' order, free of overflow at the scale's edges, within the stated
bound of a float64 sum), and `sample_plane` against autograd through the
plain forward.  The CUDA kernels against their plain versions are card
tests, in tests/test_torch_gpu.py.

Tolerances: the forward to 1e-6 (the same float32 operations as JAX's);
each gradient (d_plane, d_u, d_v) to 1e-5 of its max |value|, since JAX's
scatter-add sums each texel's float entries in its own order and the
backward rounds each entry to its scale's resolution.  Planes have
H != W, so a swapped axis shows.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.models import triplane as t_tri
from splatco_torch.ops import plane_sample as ps
from splatco_tpu.models import triplane as j_tri

R, H, W = 3, 13, 9
GRAD_TOL = 1e-5


def coords(case: str, n: int, seed: int):
    """u, v [n] float32 of one case."""
    rng = np.random.default_rng(seed)
    if case == "out_of_range":
        u, v = rng.uniform(-1.6, 1.6, (2, n))
    else:
        u, v = rng.uniform(-1.0, 1.0, (2, n))
    if case == "corners_edges":
        # the four corners, then points on each edge and on texel lines
        u[:4], v[:4] = [-1, 1, -1, 1], [-1, -1, 1, 1]
        lines = np.linspace(-1.0, 1.0, 7)
        u[4:11], v[4:11] = lines, 1.0
        u[11:18], v[11:18] = -1.0, lines
        u[18:25], v[18:25] = lines, lines[::-1]
    if case == "one_point":
        k = int(0.9 * n)
        u[:k], v[:k] = 0.123, -0.4567
    return u.astype(np.float32), v.astype(np.float32)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


CASES = {"in_range": 600, "out_of_range": 600, "corners_edges": 600,
         "one_point": 40_000}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_jax(case):
    """Plain forward and backward against `_sample_plane` and its
    `jax.vjp`; with 90 % of 40,000 rows at one point, each of its four
    texels sums 36,000 entries."""
    n = CASES[case]
    rng = np.random.default_rng(1)
    plane = rng.normal(size=(R, H, W)).astype(np.float32)
    g = rng.normal(size=(n, R)).astype(np.float32)
    u, v = coords(case, n, 2)
    want, vjp = jax.vjp(j_tri._sample_plane, jnp.asarray(plane),
                        jnp.asarray(u), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    tu, tv, tp = torch.tensor(u), torch.tensor(v), torch.tensor(plane)
    got = ps.plane_sample_fwd_plain(tp, tu, tv)
    assert got.shape == (n, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    grads = ps.plane_sample_bwd_plain(torch.tensor(g), tu, tv, tp)
    for name, a, b in zip(("d_plane", "d_u", "d_v"), grads, want_grads):
        assert a.shape == b.shape, name
        assert rel(a.numpy(), b) <= GRAD_TOL, (name, rel(a.numpy(), b))
    if case == "out_of_range":
        assert (got.abs().sum(1) == 0).any()  # some rows fully outside


def test_off_plane_corners_get_no_gradient():
    """A row wholly off the plane sends nothing to d_plane and has zero
    coordinate gradients."""
    u = np.array([3.0, -2.5, 0.1], np.float32)
    v = np.array([0.2, 4.0, 0.3], np.float32)
    plane = torch.tensor(np.random.default_rng(4).normal(
        size=(R, H, W)).astype(np.float32))
    g = torch.zeros(3, R)
    g[:2] = 1.0
    tu, tv = torch.tensor(u), torch.tensor(v)
    d_plane, d_u, d_v = ps.plane_sample_bwd_plain(g, tu, tv, plane)
    assert not d_plane.any()
    assert not d_u[:2].any() and not d_v[:2].any()
    # the third row (g = 0 there) alone reaches the plane: still nothing
    g[2] = 1.0
    d_plane = ps.plane_sample_bwd_plain(g, tu, tv, plane, coords=False)[0]
    assert int((d_plane != 0).sum()) == 4 * R


def test_row_order_does_not_change_d_plane():
    """A seeded permutation of the rows (and of g with them) gives
    d_plane bit for bit: the integer sums have no order."""
    n = 5000
    u, v = coords("one_point", n, 9)
    rng = np.random.default_rng(10)
    plane = torch.tensor(rng.normal(size=(R, H, W)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, R)).astype(np.float32))
    tu, tv = torch.tensor(u), torch.tensor(v)
    want = ps.plane_sample_bwd_plain(g, tu, tv, plane, coords=False)[0]
    for seed in (0, 1):
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(n))
        got = ps.plane_sample_bwd_plain(g[perm], tu[perm], tv[perm], plane,
                                        coords=False)[0]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# |g| at a binade's two edges: a power of two, and the float32 just below
# the next one (the same exponent e, the largest sum it allows)
EDGES = {"power": 1.0, "below_next": float(np.nextafter(np.float32(2.0),
                                                        np.float32(0.0)))}


@pytest.mark.parametrize("n", [2 ** 29 - 1, 2 ** 20, 2 ** 20 + 1, 1])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_scale_leaves_int64_room(n, edge):
    """For every row count up to the largest the int32 guards allow and
    |g| at either edge of a binade (and at the float32 range's ends), the
    worst sum, every row's whole weight at one texel with max|g| and n / 2
    of rounding, stays inside int64, while four times the scale would not
    keep n * max|g| * 2**k under 2**62 (k is within 2 of the largest k
    that does)."""
    for m in (EDGES[edge], EDGES[edge] * 2.0 ** 100,
              EDGES[edge] * 2.0 ** -100, float(np.finfo(np.float32).max),
              float(np.finfo(np.float32).smallest_subnormal)):
        k = ps.grad_exponent(m, n)
        assert -126 <= k <= 126
        worst = math.ceil(n * m * 2.0 ** k) + n // 2 + 1  # exact: m, 2**k
        assert worst < 2 ** 63
        if -126 < k < 126:
            assert n * m * 2.0 ** k <= 2.0 ** 62 < n * m * 2.0 ** (k + 2)


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_worst_case_sum_does_not_overflow(edge):
    """2**20 rows, R 1, all at one texel centre (weight 1 on one corner)
    with every g at max|g|: the texel's sum is n * max|g| exactly, at the
    top of the int64 range the scale allows."""
    n, m = 2 ** 20, EDGES[edge]
    u = v = torch.zeros(n)  # the centre texel (1, 1) of a 3 x 3 plane
    plane = torch.zeros((1, 3, 3))
    for sign in (1.0, -1.0):
        g = torch.full((n, 1), sign * m)
        d_plane = ps.plane_sample_bwd_plain(g, u, v, plane, coords=False)[0]
        want = torch.zeros_like(d_plane)
        want[0, 1, 1] = sign * n * m  # exact in float32
        assert torch.equal(d_plane, want)
        k = ps.grad_exponent(m, n)
        assert n * m * 2.0 ** k >= 2.0 ** 61  # the scale is at its edge


def test_zero_and_tiny_cotangents():
    """g = 0 gives zeros; a tiny g (subnormal) gives finite values within
    the bound; a NaN in g gives NaN."""
    u, v = coords("in_range", 300, 11)
    tu, tv = torch.tensor(u), torch.tensor(v)
    plane = torch.zeros((R, H, W))
    zero = ps.plane_sample_bwd_plain(torch.zeros(300, R), tu, tv, plane)
    assert not zero[0].any() and not zero[1].any() and not zero[2].any()
    tiny = torch.full((300, R), float(np.finfo(np.float32).smallest_subnormal))
    tiny[::2] *= -7
    d_plane = ps.plane_sample_bwd_plain(tiny, tu, tv, plane)[0]
    assert bool(torch.isfinite(d_plane).all())
    k = ps.grad_exponent(float(tiny.abs().max()), 300)
    assert k == 126
    assert float(d_plane.abs().max()) <= 300 * (7 * 1.5e-45 + 2.0 ** -127)
    bad = torch.ones(300, R)
    bad[5, 1] = float("nan")
    assert bool(torch.isnan(ps.plane_sample_bwd_plain(
        bad, tu, tv, plane)[0]).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_d_plane_within_bound_of_float64_sum(case):
    """Each d_plane value lies within entries * 2**-(k + 1) (the rounding
    of each entry to the scale) plus half a float32 ulp of the float64
    sum of its entries' float32 products (whose own error, ~entries *
    2**-53 of the sum of |products|, is counted too)."""
    n = CASES[case]
    rng = np.random.default_rng(12)
    g = torch.tensor((rng.normal(size=(n, R))
                      * 10.0 ** rng.uniform(-3, 3, (n, 1))).astype(
                          np.float32))
    u, v = coords(case, n, 13)
    tu, tv = torch.tensor(u), torch.tensor(v)
    plane = torch.zeros((R, H, W))
    got = ps.plane_sample_bwd_plain(g, tu, tv, plane, coords=False)[0]
    k = ps.grad_exponent(float(g.abs().max()), n)
    exact = torch.zeros((R, H * W), dtype=torch.float64)
    mag = torch.zeros((R, H * W), dtype=torch.float64)
    entries = torch.zeros(H * W, dtype=torch.float64)
    cell = ps._cell(tu, tv, H, W)
    for c in range(4):
        wgt, inb, idx = ps._corner(cell, c, H, W)
        val = (g[inb] * wgt[inb][:, None]).to(torch.float64).T
        exact.index_add_(1, idx[inb], val)
        mag.index_add_(1, idx[inb], val.abs())
        entries.index_add_(0, idx[inb], torch.ones(int(inb.sum()),
                                                   dtype=torch.float64))
    exact = exact.view(R, H, W)
    rounding = entries.view(1, H, W) * 2.0 ** -(k + 1)
    bound = (rounding + (exact.abs() + rounding) * 2.0 ** -24
             + entries.view(1, H, W) * mag.view(R, H, W) * 2.0 ** -53)
    err = (got.to(torch.float64) - exact).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("case", ["in_range", "one_point"])
def test_sample_plane_matches_autograd(case):
    """sample_plane on CPU tensors: the forward equals `_sample_plane` bit
    for bit, the gradients autograd's through it to GRAD_TOL, for every
    subset of inputs that needs a gradient."""
    n = CASES[case] // 10
    rng = np.random.default_rng(5)
    plane = torch.tensor(rng.normal(size=(R, H, W)).astype(np.float32))
    uv = torch.tensor(np.stack(coords(case, n, 6), 1))
    g = torch.tensor(rng.normal(size=(n, R)).astype(np.float32))
    for needs in ((True, True, True), (True, False, False),
                  (False, True, True)):
        leaves = [plane.clone().requires_grad_(needs[0]),
                  uv.clone().requires_grad_(needs[1])]
        # strided columns, as _split_coords gives them
        args = (leaves[0], leaves[1][:, 0], leaves[1][:, 1])
        got = ps.sample_plane(*args)
        want = t_tri._sample_plane(*args)
        assert torch.equal(got, want)
        wrt = [t for t in leaves if t.requires_grad]
        for a, b in zip(torch.autograd.grad(got, wrt, g),
                        torch.autograd.grad(want, wrt, g)):
            assert rel(a.numpy(), b.numpy()) <= GRAD_TOL
    with torch.no_grad():
        assert torch.equal(ps.sample_plane(plane, uv[:, 0], uv[:, 1]),
                           t_tri._sample_plane(plane, uv[:, 0], uv[:, 1]))


def test_sample_plane_gradcheck_float64():
    """float64, rows away from texel lines (where the bilinear weights
    have a kink): the gradients are the derivatives."""
    rng = np.random.default_rng(7)
    h, w = 6, 5
    cx = rng.integers(0, h - 1, 8) + rng.uniform(0.2, 0.8, 8)
    cy = rng.integers(0, w - 1, 8) + rng.uniform(0.2, 0.8, 8)
    u = torch.tensor(cx / (h - 1) * 2 - 1, requires_grad=True)
    v = torch.tensor(cy / (w - 1) * 2 - 1, requires_grad=True)
    plane = torch.tensor(rng.normal(size=(2, h, w)), requires_grad=True)
    assert torch.autograd.gradcheck(ps.sample_plane, (plane, u, v))


def test_wrappers_take_cpu_or_cuda_only():
    plane = torch.zeros((R, H, W), device="meta")
    u = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ps.plane_sample_fwd(plane, u, u)
    with pytest.raises(ValueError, match="contiguous"):
        ps.plane_sample_fwd(torch.zeros((R, W, H)).transpose(1, 2),
                            torch.zeros(4), torch.zeros(4))

