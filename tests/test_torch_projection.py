"""The EWA projection's kernel pair on the CPU (ops/projection.py): the
plain forward (`covariance_cols` + `project_cols`, what `project_fwd`
runs for CPU tensors) against the JAX package's
`project_gaussians_cols`, the hand-written VJP (`_project_bwd_plain`,
what `project_bwd` runs) against `jax.grad` and against autograd through
the formula, the autograd Function `_Project`, the wrappers' refusals,
and the call sites that must go through it: the prefilter, the render
and the sharded step.  chip_smoke.py's helpers for the card's cases
(ragged sizes as views into larger tensors, culled cotangents) and the
IEEE rule `project::div_cot` (csrc/project.cuh) relies on are checked
here too.

Inputs are seeded with numpy: a few thousand gaussians around the
origin, N = 1 and N = 33, and chip_smoke.py's crafted rows (behind the
near plane, |tz| < 1e-8, a zero quaternion, zero scales, NaN and inf
entries, tx / tz exactly at the frustum limit; det == 0 under a singular
view).  Tolerances: the forward's columns as tests/test_torch_modules.py
holds them (rtol 1e-5, atol 1e-4 on visible rows, the radii equal); the
VJP at PERF.md's `jax.grad` gate, 5e-4 of each gradient's max (XLA fuses
and reorders the sums), and against autograd through the same float32
formula at 1e-5 of each column's max (the same chain rule, summed in
another order), 1e-12 in float64.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (PROJ_RAGGED_N, PROJ_VIEW_OFFSETS, culled_cotangents,
                        projection_crafted_cases, projection_ragged_cases,
                        rows_at_offset)
from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data import cameras as t_cam
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops import cuda_lib
from splatco_torch.ops import projection as t_proj
from splatco_torch.parallel import distributed
from splatco_torch.parallel.train_step import make_sharded_train_step
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import init_stats, make_train_step
from splatco_tpu.data import cameras as j_cam
from splatco_tpu.ops import projection as j_proj

CAMERAS = [
    ([0, 0, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48),
    ([2.5, 0.4, -1.0], [0.1, 0, 0.2], [0, -1, 0], 1.2, 0.9, 96, 64),
]
COLS = ("mx", "my", "depth", "ca", "cb", "cc")
GRAD_TOL = 5e-4  # of each gradient's max, against jax.grad
AUTOGRAD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def gaussians(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    scales = (0.01 + 0.1 * rng.uniform(size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return means, scales, quats


def cameras(cam_args):
    return (j_cam.look_at_camera(*cam_args),
            t_cam.look_at_camera(*cam_args, device="cpu"))


def geometry(cam):
    return (cam.world_view_transform, cam.full_proj_transform,
            cam.image_width, cam.image_height, cam.tan_fovx, cam.tan_fovy)


def crafted(i):
    """chip_smoke.py's crafted case i: (numpy arrays, torch inputs)."""
    arrays = projection_crafted_cases()[i][1]
    return arrays, (*(torch.from_numpy(a) for a in arrays[:5]), *arrays[5:])


def j_project(arrays):
    means, scales, quats, vm, pm, *geom = arrays
    return j_proj.project_cols(
        jnp.asarray(means), j_proj.covariance_cols(jnp.asarray(scales),
                                                   jnp.asarray(quats)),
        jnp.asarray(vm), jnp.asarray(pm), *geom)


def assert_forward_close(want, got):
    """Equal radii; each column to rtol 1e-5, atol 1e-4 on visible
    rows."""
    radius = np.asarray(want.radius)
    np.testing.assert_array_equal(radius, got.radius.numpy())
    vis = radius > 0
    for name in COLS:
        np.testing.assert_allclose(np.asarray(getattr(want, name))[vis],
                                   getattr(got, name).numpy()[vis],
                                   rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n", [3000, 1, 33])
@pytest.mark.parametrize("cam_args", CAMERAS)
def test_forward_matches_jax(cam_args, n):
    means, scales, quats = gaussians(n, n)
    jc, tc = cameras(cam_args)
    want = j_proj.project_gaussians_cols(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jc)
    got = t_proj.project_gaussians_cols(torch.from_numpy(means),
                                        torch.from_numpy(scales),
                                        torch.from_numpy(quats), tc)
    if n == 3000:
        assert (np.asarray(want.radius) > 0).sum() > 1000
    assert_forward_close(want, got)
    np.testing.assert_array_equal(
        np.asarray(j_proj.visible_filter(jnp.asarray(means),
                                         jnp.asarray(scales),
                                         jnp.asarray(quats), jc)),
        t_proj.visible_filter(torch.from_numpy(means),
                              torch.from_numpy(scales),
                              torch.from_numpy(quats), tc).numpy())


def test_crafted_rows_match_jax():
    """Every degenerate row gives JAX's radius (0 where it culls, NaN and
    inf included; the rows exactly at the frustum limit visible), and the
    visible rows JAX's columns."""
    arrays, inputs = crafted(0)
    want = j_project(arrays)
    got = t_proj.ProjectedCols(*t_proj.project_fwd(*inputs).unbind(0))
    assert_forward_close(want, got)
    radius = got.radius.numpy()
    assert (radius > 0).sum() == 9 and radius[11:16].all()
    means, scales, quats = arrays[:3]
    bad = ~(np.isfinite(means).all(1) & np.isfinite(scales).all(1)
            & np.isfinite(quats).all(1))
    assert bad.sum() == 9 and not radius[bad].any()
    near = means[:, 2] <= 0.2
    assert not radius[near].any()


def test_det_zero_is_culled():
    """Under the singular view M's rows are equal, so cov2D's determinant
    is exactly 0 for the large gaussians: the plain forward culls them
    and writes a zero conic, as the formula's where-guards say."""
    _, inputs = crafted(1)
    out = t_proj.project_fwd(*inputs)
    t = t_proj._ewa_terms(inputs[0], t_proj.covariance_cols(*inputs[1:3]),
                          *inputs[3:])
    assert bool((t.det == 0).all())
    assert not out[6].any() and not out[3:6].any()


def hand_vjp(cots, inputs):
    return t_proj._project_bwd_plain(cots, *inputs)


def autograd_vjp(cots, inputs):
    means, scales, quats, *rest = inputs
    leaves = [x.detach().clone().requires_grad_() for x in
              (means, scales, quats)]
    out = t_proj.project_cols(leaves[0], t_proj.covariance_cols(*leaves[1:]),
                              *rest)
    terms = [(o * g).sum() for o, g in zip(out[:6], cots) if g is not None]
    return torch.autograd.grad(sum(terms), leaves)


def rel_err(got, want):
    """max |got - want| of each column over that column's max |want|."""
    d = (got - want).abs().amax(dim=0)
    return float((d / want.abs().amax(dim=0).clamp_min(1e-30)).max())


def seeded_cots(n, seed, dtype=torch.float32, depth=False):
    rng = np.random.default_rng(seed)
    g = [torch.tensor(rng.normal(size=n), dtype=dtype) for _ in range(6)]
    if not depth:
        g[2] = None
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3000, 1, 33])
def test_hand_vjp_matches_autograd(n, dtype):
    """The hand VJP against autograd through the same formula, every
    cotangent (the depth's too) and the render's five."""
    means, scales, quats = gaussians(n, n + 1)
    _, tc = cameras(CAMERAS[1])
    inputs = (*(torch.from_numpy(a).to(dtype) for a in (means, scales,
                                                          quats)),
              tc.world_view_transform.to(dtype),
              tc.full_proj_transform.to(dtype), *geometry(tc)[2:])
    for depth in (True, False):
        cots = seeded_cots(n, n, dtype, depth)
        for got, want in zip(hand_vjp(cots, inputs),
                             autograd_vjp(cots, inputs)):
            assert rel_err(got, want) <= AUTOGRAD_TOL[dtype]


@pytest.mark.parametrize("case", [0, 1])
def test_hand_vjp_on_crafted_rows(case):
    """On the crafted rows the hand VJP is finite wherever autograd's is,
    and agrees with it there (the zero quaternion's row is NaN in both:
    sqrt's gradient at 0 is 0 / 0)."""
    arrays, inputs = crafted(case)
    n = arrays[0].shape[0]
    cots = seeded_cots(n, 5, depth=True)
    for got, want in zip(hand_vjp(cots, inputs), autograd_vjp(cots, inputs)):
        ok = torch.isfinite(want).all(dim=1)
        assert torch.equal(torch.isfinite(got).all(dim=1), ok)
        assert rel_err(got[ok], want[ok]) <= AUTOGRAD_TOL[torch.float32]


def visible_weighted_sum(n, seed, radius):
    """Seeded weights of mx, my and the conic on the visible rows: the
    cotangents a render's backward sends."""
    rng = np.random.default_rng(seed)
    vis = (np.asarray(radius) > 0).astype(np.float32)
    return [rng.normal(size=n).astype(np.float32) * vis for _ in range(5)]


@pytest.mark.parametrize("cam_args", CAMERAS)
def test_hand_vjp_matches_jax_grad(cam_args):
    """`_project_bwd_plain` against `jax.grad` of a seeded weighted sum of
    mx, my, ca, cb and cc (the visible rows) with respect to means, scales
    and quats, at 5e-4 of each gradient's max."""
    means, scales, quats = gaussians(3000, 3)
    jc, tc = cameras(cam_args)
    radius = j_proj.project_gaussians_cols(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jc).radius
    w = visible_weighted_sum(3000, 4, radius)

    def loss(m, s, q):
        p = j_proj.project_gaussians_cols(m, s, q, jc)
        return sum(jnp.sum(c * jnp.asarray(wi)) for c, wi in
                   zip((p.mx, p.my, p.ca, p.cb, p.cc), w))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats))
    tw = [torch.from_numpy(x) for x in w]
    cots = (tw[0], tw[1], None, tw[2], tw[3], tw[4])
    got = hand_vjp(cots, (torch.from_numpy(means), torch.from_numpy(scales),
                          torch.from_numpy(quats), *geometry(tc)))
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= GRAD_TOL * np.abs(j).max()


def test_function_takes_the_hand_vjp():
    """`project_gaussians` forward equals the plain forward and its
    gradients equal `_project_bwd_plain` bit for bit; the radius has no
    gradient; an output with no cotangent counts as zeros; with no
    cotangent at all the inputs get none."""
    means, scales, quats = gaussians(500, 7)
    _, tc = cameras(CAMERAS[0])
    geom = geometry(tc)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (means, scales, quats)]
    out = t_proj.project_gaussians(*leaves, *geom)
    plain = t_proj._project_fwd_plain(*(x.detach() for x in leaves), *geom)
    for got, want in zip(out, plain):
        assert torch.equal(got, want)
    assert not out.radius.requires_grad
    cots = seeded_cots(500, 8)
    loss = sum((o * g).sum() for o, g in zip(out[:6], cots) if g is not None)
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    want = hand_vjp(cots, (*(x.detach() for x in leaves), *geom))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (g_mx,) = torch.autograd.grad(out.mx.sum(), leaves[:1])
    want = hand_vjp((torch.ones(500),) + (None,) * 5,
                    (*(x.detach() for x in leaves), *geom))[0]
    assert torch.equal(g_mx, want)


def test_function_keeps_only_its_inputs():
    """The backward recomputes the forward: the graph saves the three
    inputs and the two matrices, nothing of [N] size else."""
    means, scales, quats = gaussians(64, 9)
    _, tc = cameras(CAMERAS[0])
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (means, scales, quats)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        t_proj.project_gaussians(*leaves, *geometry(tc))
    assert len(saved) == 5
    assert {tuple(t.shape) for t in saved} == {(64, 3), (64, 4), (4, 4)}


def test_noncontiguous_inputs_are_made_contiguous():
    """The prefilter's base scales are the strided slice exp(s)[:, :3]:
    the wrappers take it as its contiguous copy."""
    means, scales, quats = gaussians(300, 10)
    _, tc = cameras(CAMERAS[0])
    wide = torch.from_numpy(np.concatenate([scales, scales], axis=1))
    assert not wide[:, :3].is_contiguous()
    args = (torch.from_numpy(means), wide[:, :3], torch.from_numpy(quats),
            *geometry(tc))
    want = (torch.from_numpy(means), torch.from_numpy(scales),
            torch.from_numpy(quats), *geometry(tc))
    assert torch.equal(t_proj.project_fwd(*args), t_proj.project_fwd(*want))
    cots = seeded_cots(300, 11)
    for a, b in zip(t_proj.project_bwd(cots, *args),
                    t_proj.project_bwd(cots, *want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", PROJ_VIEW_OFFSETS)
def test_rows_at_offset_are_views_past_the_base(offset):
    """chip_smoke.rows_at_offset, which gives the card's kernels bases 12
    and 36 B into [N, 3] rows (16 and 48 into [N, 4]): contiguous views
    `offset` rows into NaN tensors, holding the rows bit for bit."""
    arrays = gaussians(5, 31)
    for a, v in zip(arrays, rows_at_offset(arrays, offset,
                                           torch.device("cpu"))):
        k = a.shape[1]
        assert v.is_contiguous() and v.storage_offset() == k * offset
        assert v.data_ptr() - v.untyped_storage().data_ptr() == 4 * k * offset
        np.testing.assert_array_equal(v.numpy(), a)
        head = v.as_strided((offset, k), (k, 1), storage_offset=0)
        assert bool(head.isnan().all())


@pytest.mark.parametrize("offset", PROJ_VIEW_OFFSETS)
@pytest.mark.parametrize("n", PROJ_RAGGED_N)
def test_ragged_views_match_jax_and_their_copies(n, offset):
    """chip_smoke's ragged cases (phase 23a and the card tests) on the
    CPU: the wrappers take the views as they are, the forward agrees with
    JAX's on the same rows, and the VJP on the views equals the VJP on
    fresh copies bit for bit, with seeded and with culled cotangents."""
    cases = dict(projection_ragged_cases(torch.device("cpu"), 7))
    inputs = cases[f"N {n}, {offset} rows in"]
    means, scales, quats, vm, pm, *geom = inputs
    assert means.storage_offset() == 3 * offset
    copies = (means.clone(), scales.clone(), quats.clone(), vm, pm, *geom)
    assert copies[0].storage_offset() == 0
    got = t_proj.project_fwd(*inputs)
    assert torch.equal(got, t_proj.project_fwd(*copies))
    want = j_project((means.numpy(), scales.numpy(), quats.numpy(),
                      vm.numpy(), pm.numpy(), *geom))
    assert_forward_close(want, t_proj.ProjectedCols(*got))
    seeded = seeded_cots(n, n)
    for cots in (seeded, culled_cotangents(seeded, inputs)):
        for a, b in zip(t_proj.project_bwd(cots, *inputs),
                        t_proj.project_bwd(cots, *copies)):
            assert torch.equal(a, b)


def test_culled_cotangents_zero_the_culled_rows():
    """chip_smoke.culled_cotangents, the cotangents a step sends: zero
    exactly where the radius is 0, unchanged elsewhere, None kept."""
    arrays, inputs = crafted(0)
    n = arrays[0].shape[0]
    cots = seeded_cots(n, 17)
    got = culled_cotangents(cots, inputs)
    visible = t_proj._project_fwd_plain(*inputs, radius_only=True) > 0
    assert 0 < int(visible.sum()) < n
    assert got[2] is None
    for g, c in zip(got, cots):
        if c is not None:
            assert torch.equal(g[visible], c[visible])
            assert bool((g[~visible] == 0).all())


def test_zero_dividend_is_the_signed_zero():
    """What `project::div_cot` (csrc/project.cuh) relies on to give a zero
    dividend its quotient without the division: IEEE 0 / b is the zero
    with the sign of a XOR the sign of b for every nonzero or infinite b,
    and NaN for b = 0 or NaN."""
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    big = float(np.finfo(np.float32).max)
    b = torch.tensor([tiny, 1e-30, 0.3, 1.0, 7.0, 1e30, big, math.inf, 0.0,
                      math.nan], dtype=torch.float32)
    b = torch.cat([b, -b])
    nonzero = (b.abs() > 0).numpy()
    for a in (0.0, -0.0):
        q = (torch.full_like(b, a) / b).numpy()
        sign = np.signbit(np.float32(a)) ^ np.signbit(b.numpy())
        assert (q[nonzero] == 0).all()
        np.testing.assert_array_equal(np.signbit(q[nonzero]), sign[nonzero])
        assert np.isnan(q[~nonzero]).all()


def test_wrappers_refuse():
    means, scales, quats = (torch.from_numpy(a) for a in gaussians(10, 12))
    _, tc = cameras(CAMERAS[0])
    geom = geometry(tc)
    with pytest.raises(ValueError, match="unsupported device"):
        t_proj.project_fwd(means.to("meta"), scales.to("meta"),
                           quats.to("meta"), *(m.to("meta")
                                               for m in geom[:2]),
                           *geom[2:])
    with pytest.raises(ValueError, match="quats"):
        t_proj.project_fwd(means, scales, quats[:, :3], *geom)
    with pytest.raises(ValueError, match="quats"):
        t_proj.project_fwd(means, scales[:5], quats, *geom)
    with pytest.raises(ValueError, match="six cotangents"):
        t_proj.project_bwd((torch.zeros(10),) * 5, means, scales, quats,
                           *geom)
    with pytest.raises(ValueError, match="six cotangents"):
        t_proj.project_bwd((torch.zeros(9),) + (None,) * 5, means, scales,
                           quats, *geom)
    with pytest.raises(ValueError, match="six cotangents"):
        t_proj.project_bwd((torch.zeros(10, dtype=torch.float64),)
                           + (None,) * 5, means, scales, quats, *geom)


def test_ranges_name_the_projection():
    """Forward and backward run inside `projection` profiler ranges."""
    means, scales, quats = gaussians(100, 13)
    _, tc = cameras(CAMERAS[0])
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (means, scales, quats)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = t_proj.project_gaussians(*leaves, *geometry(tc))
        out.mx.sum().backward()
        t_proj.visible_filter(*(x.detach() for x in leaves), tc)
    names = [e.name for e in prof.events()]
    assert names.count("projection") == 3


class Calls:
    """`project_fwd` / `project_bwd` wrapped to count their calls by
    mode: the names `_Project` and the prefilter call."""

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        fwd, bwd = t_proj.project_fwd, t_proj.project_bwd

        def count_fwd(*args, radius_only=False):
            self.n["radius" if radius_only else "fwd"] += 1
            return fwd(*args, radius_only=radius_only)

        def count_bwd(*args):
            self.n["bwd"] += 1
            return bwd(*args)

        monkeypatch.setattr(t_proj, "project_fwd", count_fwd)
        monkeypatch.setattr(t_proj, "project_bwd", count_bwd)


def small_model(n_pts=300):
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0])
    pts = np.random.default_rng(0).normal(size=(n_pts, 3)).astype(
        np.float32) * 0.4
    params, state = init_model(cfg, pts, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return cfg, params, state


def test_prefilter_and_render_go_through_the_function(monkeypatch):
    """The prefilter launches the radius-only forward, the render the full
    one; the prefilter's mask equals radius > 0 of the formula; a
    training step of mv views takes 2 mv forwards and mv backwards."""
    cfg, params, state = small_model()
    cam = t_cam.look_at_camera(*CAMERAS[0], device="cpu")
    calls = Calls(monkeypatch)
    vis = prefilter_voxel(params["anchors"], state.active, cam)
    anch = params["anchors"]
    want = t_proj.project_cols(
        anch["anchor"], t_proj.covariance_cols(
            torch.exp(anch["scaling"])[:, :3],
            anch["rotation"] / torch.clamp_min(
                anch["rotation"].norm(dim=-1, keepdim=True), 1e-12)),
        *geometry(cam)).radius > 0
    assert torch.equal(vis, want & state.active)
    assert calls.n == {"radius": 1}
    with torch.no_grad():
        render(params, state.active, state.contractor, cam, torch.zeros(3),
               visible_mask=vis, activate_level=0, **decode_kwargs(cfg))
    assert calls.n == {"radius": 1, "fwd": 1}
    calls.n.clear()
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, 1.0, 0, device="cpu")
    cams = [t_cam.look_at_camera(e, [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64,
                                 48, uid=i, device="cpu")
            for i, e in enumerate([[0, 0, -3.0], [0.5, 0.3, -2.8]])]
    step = make_train_step(cfg, opt, 2, 0, tx, q_noise=0.0, device="cpu")
    step(params, tx.init(params), state.active, state.contractor,
         init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                    device="cpu"), cams,
         [torch.full((3, 48, 64), 0.5)] * 2, torch.zeros(3), None, 0, 1.0,
         0.0, 1.0)
    assert calls.n == {"radius": 2, "fwd": 2, "bwd": 2}


@pytest.fixture
def one_rank():
    assert distributed.init_distributed(
        f"localhost:{free_port()}", 1, 0, device="cpu")
    yield
    torch.distributed.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_sharded_step_goes_through_the_function(one_rank, monkeypatch):
    """The sharded step's prefilter (the view's true geometry) and render
    both go through the projection's wrappers: one radius-only forward,
    one full forward and one backward a step on a 1x1 mesh."""
    cfg, params, state = small_model()
    mesh = distributed.make_multihost_mesh(1, 1)
    cam = t_cam.look_at_camera([0.0, 0.3, -3.0], [0, 0, 0], [0, -1, 0], 1.0,
                               0.5, 64, 32, device="cpu")
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, 1.0, 0, device="cpu")
    stats = init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                       device="cpu")
    step = make_sharded_train_step(cfg, opt, mesh, tx, backend="dense",
                                   q_noise=0.0, device="cpu")
    calls = Calls(monkeypatch)
    out = step(params, tx.init(params), state.active, state.contractor,
               stats, cam, torch.full((3, 32, 64), 0.5), 0, 1.0, 0.0, 1.0)
    assert math.isfinite(float(out[3]["loss"]))
    assert calls.n == {"radius": 1, "fwd": 1, "bwd": 1}


def test_cpu_takes_the_plain_versions_and_launches_nothing():
    means, scales, quats = (torch.from_numpy(a) for a in gaussians(50, 14))
    _, tc = cameras(CAMERAS[0])
    before = collections.Counter(cuda_lib.LAUNCHES)
    out = t_proj.project_fwd(means, scales, quats, *geometry(tc))
    t_proj.project_bwd(seeded_cots(50, 15), means, scales, quats,
                       *geometry(tc))
    assert cuda_lib.LAUNCHES == before
    assert out.shape == (7, 50)
