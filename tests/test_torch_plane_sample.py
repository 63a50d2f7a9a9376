"""The tri-plane sampler (splatco_torch/ops/plane_sample.py) on the CPU:
its plain forward and backward against JAX's `_sample_plane` and
`jax.vjp` of it, the key table, and `sample_plane` against autograd
through the plain forward.  The CUDA kernels against their plain versions
are card tests, in tests/test_torch_gpu.py.

Tolerances: the forward to 1e-6 (the same float32 operations as JAX's);
each gradient (d_plane, d_u, d_v) to 1e-5 of its max |value|, since JAX's
scatter-add and the key table's fixed order sum each texel's entries in
different orders.  Planes have H != W, so a swapped axis shows.
"""
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
    texels sums 36,000 entries across 141 chunks (5 butterfly rounds)."""
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
    table = ps.key_table(ps.corner_keys_plain(tu, tv, H, W))
    grads = ps.plane_sample_bwd_plain(torch.tensor(g), tu, tv, tp, table)
    for name, a, b in zip(("d_plane", "d_u", "d_v"), grads, want_grads):
        assert a.shape == b.shape, name
        assert rel(a.numpy(), b) <= GRAD_TOL, (name, rel(a.numpy(), b))
    if case == "out_of_range":
        assert (got.abs().sum(1) == 0).any()  # some rows fully outside


def test_key_table_is_stable_and_drops_off_plane_corners():
    u, v = coords("out_of_range", 500, 3)
    u[100:140], v[100:140] = 0.25, 0.5  # 40 rows sharing four cells
    tu, tv = torch.tensor(u), torch.tensor(v)
    keys = ps.corner_keys_plain(tu, tv, H, W)
    assert keys.dtype == torch.int32 and keys.shape == (4 * 500,)
    # the keys the plain forward's corners read: in-bounds corners only
    x = (tu + 1.0) * 0.5 * (H - 1)
    y = (tv + 1.0) * 0.5 * (W - 1)
    for k, (dx, dy) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        cx, cy = torch.floor(x) + dx, torch.floor(y) + dy
        inb = (cx >= 0) & (cx <= H - 1) & (cy >= 0) & (cy <= W - 1)
        want = torch.where(inb, (cx * W + cy).to(torch.int32), H * W)
        assert torch.equal(keys[k::4], want)
    sorted_keys, order = ps.key_table(keys)
    assert torch.equal(keys[order], sorted_keys)
    on_plane = sorted_keys < H * W
    off = int((keys == H * W).sum())
    assert off > 0 and int((~on_plane).sum()) == off
    assert bool(on_plane[:on_plane.sum()].all())  # off-plane corners last
    # equal cells keep row (and corner) order
    same = sorted_keys[1:] == sorted_keys[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    # a cell the 40 shared rows reach lists them (and any other row
    # there) in row order
    cell = keys[4 * 100]
    rows = order[sorted_keys == cell] // 4
    assert bool((rows[1:] > rows[:-1]).all())
    assert torch.equal(rows[(rows >= 100) & (rows < 140)],
                       torch.arange(100, 140))


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
    table = ps.key_table(ps.corner_keys_plain(tu, tv, H, W))
    d_plane, d_u, d_v = ps.plane_sample_bwd_plain(g, tu, tv, plane, table)
    assert not d_plane.any()
    assert not d_u[:2].any() and not d_v[:2].any()


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

