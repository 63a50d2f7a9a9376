"""Densification, graph downsampling, capacity regrowth and CVPM of
splatco_torch against splatco_tpu, on the CPU.

The port takes its two random draws as arguments; here they are JAX's own
(`jax.random.split` / `uniform` exactly as `adjust_anchor` and
`graph_downsample` draw them), so the two packages must agree:
  * integers exactly: the active mask, the grown / pruned / dropped
    counts, and which rows moved where (every row carries distinct
    values, so the row data pins the permutation);
  * params, Adam moments and statistics to 1e-6 relative (new rows' log
    scale and opacity logit are the only values computed, not copied).
CVPM masks are held equal away from 1e-5 of each threshold, curvature to
1e-4 absolute, and the curvature mask equal away from 1e-4 of 0.1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses_optim import flat_numpy

from splatco_torch.models.anchors import grow_capacity
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.train import cvpm as t_cvpm
from splatco_torch.train import densify as t_den
from splatco_torch.train.optimizer import opt_state_from_numpy
from splatco_torch.train.step import TrainStats
from splatco_tpu.config import ModelConfig as JModelConfig
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.models.anchors import AnchorState
from splatco_tpu.models.anchors import grow_capacity as j_grow_capacity
from splatco_tpu.models.splatco import init_model as j_init_model
from splatco_tpu.train import cvpm as j_cvpm
from splatco_tpu.train import densify as j_den
from splatco_tpu.train.optimizer import make_optimizer as j_make_optimizer
from splatco_tpu.train.step import init_stats as j_init_stats

STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")
K = 4


def build(capacity=0, seed=0):
    """A JAX model of ~200 anchors with distinct random rows, random Adam
    moments and statistics: (params, opt_state, active, stats)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.5
    cfg = JModelConfig(feat_dim=8, n_offsets=K, voxel_size=0.05,
                       plane_size=32, num_channels=9, appearance_dim=0,
                       capacity=capacity)
    params, state = j_init_model(jax.random.key(0), cfg, pts)
    c = params["anchors"]["anchor"].shape[0]
    anchors = dict(params["anchors"])
    anchors["feat"] = jnp.asarray(rng.normal(size=(c, 8)), jnp.float32)
    # spread offsets, so candidate gaussians land in unoccupied voxels
    anchors["offsets"] = jnp.asarray(rng.normal(size=(c, K, 3)) * 8.0,
                                     jnp.float32)
    anchors["opacity"] = jnp.asarray(rng.normal(size=(c, 1)), jnp.float32)
    params = dict(params, anchors=anchors)
    opt_state = j_make_optimizer(JOptimizationConfig(), params, 1.0,
                                 0).init(params)
    mu, nu, _ = j_den._anchor_moments(opt_state)
    mu = {n: jnp.asarray(rng.normal(size=a.shape), jnp.float32)
          for n, a in mu.items()}
    nu = {n: jnp.asarray(rng.uniform(size=a.shape), jnp.float32)
          for n, a in nu.items()}
    opt_state = j_den._write_anchor_moments(opt_state, mu, nu)
    stats = dataclasses.replace(
        j_init_stats(c, K),
        opacity_accum=jnp.asarray(rng.uniform(size=(c, 1)), jnp.float32),
        anchor_demon=jnp.asarray(rng.integers(0, 200, (c, 1)),
                                 jnp.float32),
        offset_gradient_accum=jnp.asarray(
            rng.uniform(size=(c * K, 1)) * 0.1, jnp.float32),
        offset_denom=jnp.asarray(rng.integers(0, 100, (c * K, 1)),
                                 jnp.float32))
    return params, opt_state, state.active, stats


def to_port(params, opt_state, active, stats):
    return (params_from_numpy(flat_numpy(params), device="cpu"),
            opt_state_from_numpy(flat_numpy(opt_state), device="cpu"),
            torch.as_tensor(np.array(active)),
            TrainStats(**{f: torch.as_tensor(np.array(getattr(stats, f)))
                          for f in STAT_FIELDS}))


def keep_draws(key, depth, n):
    """adjust_anchor's stochastic-keep draws: one uniform [n] per depth
    from successive splits of `key`."""
    out = []
    for _ in range(depth):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (n,))))
    return torch.as_tensor(np.stack(out))


def close(want, got, name, rtol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0, err_msg=name)


def check_same(jres, tres):
    """The JAX and port results of a densify call agree."""
    for f in ("num_active", "num_grown", "num_pruned", "num_dropped"):
        assert int(getattr(tres, f)) == int(getattr(jres, f)), f
    np.testing.assert_array_equal(tres.active.numpy(),
                                  np.asarray(jres.active))
    for name in t_den.ROW_FIELDS:
        close(jres.params["anchors"][name], tres.params["anchors"][name],
              name)
    jmu, jnu, _ = j_den._anchor_moments(jres.opt_state)
    for name in t_den.ROW_FIELDS:
        close(jmu[name], tres.opt_state["mu"]["anchors"][name], "mu " + name)
        close(jnu[name], tres.opt_state["nu"]["anchors"][name], "nu " + name)
    for f in STAT_FIELDS:
        close(getattr(jres.stats, f), getattr(tres.stats, f), f)


def _case(name):
    """(JAX state, adjust_anchor keywords) of one named case."""
    params, opt_state, active, stats = build(
        capacity=256 if name == "overflow" else 0)
    c = params["anchors"]["anchor"].shape[0]
    rng = np.random.default_rng(5)
    kw = dict(voxel_size=0.05, grad_threshold=2e-4,
              extra_offset_mask=np.zeros(c * K, bool),
              cvpm_prune=np.zeros(c, bool), dedup_mode="max")
    if name in ("grow_max", "grow_first", "overflow"):
        # high gradients on every observed slot
        stats = dataclasses.replace(
            stats, offset_gradient_accum=jnp.full((c * K, 1), 1.0),
            offset_denom=jnp.full((c * K, 1), 100.0))
        kw["dedup_mode"] = "max" if name != "grow_first" else "first"
    elif name == "prune":
        # low opacity over a well-observed window, plus a CVPM mask
        stats = dataclasses.replace(
            stats, opacity_accum=jnp.asarray(
                rng.uniform(size=(c, 1)) * 2.0, jnp.float32),
            anchor_demon=jnp.full((c, 1), 100.0))
        kw.update(grad_threshold=1e9,
                  cvpm_prune=rng.uniform(size=c) < 0.1)
    elif name == "clamp":
        sc = params["anchors"]["scaling"].at[:, 3:].set(
            jnp.asarray(rng.uniform(-1, 1, size=(c, 3)), jnp.float32))
        params = dict(params, anchors=dict(params["anchors"], scaling=sc))
        kw["grad_threshold"] = 1e9
    elif name == "curvature":
        # the statistics' own slots plus a curvature offset mask
        kw["extra_offset_mask"] = rng.uniform(size=c * K) < 0.3
    return (params, opt_state, active, stats), kw


@pytest.mark.parametrize("name", ["grow_max", "grow_first", "prune",
                                  "clamp", "overflow", "curvature"])
def test_adjust_anchor_matches_jax(name):
    (params, opt_state, active, stats), kw = _case(name)
    c = params["anchors"]["anchor"].shape[0]
    key = jax.random.key(11)
    jres = j_den.adjust_anchor(
        params, opt_state, active, stats, key, kw["voxel_size"],
        jnp.float32(kw["grad_threshold"]),
        jnp.asarray(kw["extra_offset_mask"]), jnp.asarray(kw["cvpm_prune"]),
        dedup_mode=kw["dedup_mode"])
    tres = t_den.adjust_anchor(
        *to_port(params, opt_state, active, stats), keep_draws(key, 3, c * K),
        kw["voxel_size"], kw["grad_threshold"],
        torch.as_tensor(kw["extra_offset_mask"]),
        torch.as_tensor(kw["cvpm_prune"]), dedup_mode=kw["dedup_mode"])
    check_same(jres, tres)
    n = int(tres.num_active)
    act = tres.active.numpy()
    assert act[:n].all() and not act[n:].any()
    if name.startswith("grow"):
        assert int(tres.num_grown) > 0
    if name == "overflow":
        # the capacity filled before the prune
        assert int(tres.num_dropped) > 0
        assert n + int(tres.num_pruned) == c
    if name == "prune":
        assert int(tres.num_pruned) > 0
    if name == "clamp":
        sc = tres.params["anchors"]["scaling"][:, 3:]
        assert float(sc.max()) == np.float32(0.05)


def test_graph_downsample_matches_jax():
    params, opt_state, active, stats = build(seed=3)
    key = jax.random.key(4)
    c = active.shape[0]
    jp, jo, ja, js, jn = j_den.graph_downsample(
        params, opt_state, active, stats, key, jnp.float32(0.65))
    tp, to, ta, ts, tn = t_den.graph_downsample(
        *to_port(params, opt_state, active, stats),
        torch.as_tensor(np.array(jax.random.uniform(key, (c,)))), 0.65)
    assert int(tn) == int(jn) == int(np.floor(int(active.sum()) * 0.65))
    jres = j_den.DensifyResult(jp, jo, ja, js, jn, 0, 0, 0)
    tres = t_den.DensifyResult(tp, to, ta, ts, tn, 0, 0, 0)
    check_same(jres, tres)


def test_grow_capacity_matches_jax():
    params, _, active, _ = build(seed=2)
    anchors = {n: torch.as_tensor(np.array(a))
               for n, a in params["anchors"].items()}
    new_cap = active.shape[0] * 2
    js = j_grow_capacity(AnchorState(active=active, **params["anchors"]),
                         new_cap)
    got, got_active = grow_capacity(anchors, torch.as_tensor(
        np.array(active)), new_cap)
    np.testing.assert_array_equal(got_active.numpy(), np.asarray(js.active))
    for name, a in got.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(js,
                                                                    name)))


def test_hash_and_run_max_match_jax():
    """int32 wrap-around of the voxel hash (negative and large coords),
    and the per-run max, exactly."""
    rng = np.random.default_rng(9)
    coords = rng.integers(-2 ** 20, 2 ** 20, size=(4000, 3), dtype=np.int32)
    for consts in (t_den.HASH_A, t_den.HASH_B):
        np.testing.assert_array_equal(
            t_den._hash_coords(torch.as_tensor(coords), consts).numpy(),
            np.asarray(j_den._hash_coords(jnp.asarray(coords), consts)))
    first = rng.uniform(size=500) < 0.2
    first[0] = True
    vals = rng.normal(size=(500, 6)).astype(np.float32)
    # adjust_anchor reads a run's max at its first row only
    np.testing.assert_array_equal(
        t_den._segment_run_max(torch.as_tensor(vals),
                               torch.as_tensor(first)).numpy()[first],
        np.asarray(j_den._segment_run_max(jnp.asarray(vals),
                                          jnp.asarray(first)))[first])


def _margins(anchor, active, c1, c2, thr):
    """float64 distance of each anchor's three CVPM comparisons from their
    thresholds (the smallest of them)."""
    a = anchor.astype(np.float64)
    out = []
    for o, other in ((c1, c2), (c2, c1)):
        ray = (other - o) / np.linalg.norm(other - o)
        d = a - o
        proj = o + ray * (d @ ray)[:, None]
        out.append(np.abs(np.linalg.norm(a - proj, axis=1) - thr))
        out.append(np.abs(np.linalg.norm(d, axis=1) - 0.5))
    m = a[active]
    mean, std = m.mean(0), m.std(0, ddof=1)
    out.append(np.abs(np.abs(a - mean) - 3.0 * std).min(axis=1))
    return np.min(out, axis=0)


def test_cvpm_pair_mask_matches_jax():
    rng = np.random.default_rng(21)
    hits = 0
    for pair in range(6):
        c1, c2 = rng.normal(size=(2, 3)) * 1.5
        # anchors near the baseline (some within the threshold of both
        # rays), near the cameras, and a scattered cloud with outliers
        t = rng.uniform(-0.5, 1.5, size=(600, 1))
        line = c1 + t * (c2 - c1) + rng.normal(size=(600, 3)) * 0.03
        cloud = rng.standard_t(3, size=(900, 3))
        anchor = np.concatenate([line, cloud]).astype(np.float32)
        active = rng.uniform(size=len(anchor)) < 0.9
        thr = 0.04
        want = np.asarray(j_cvpm.cvpm_pair_mask(
            jnp.asarray(anchor), jnp.asarray(active),
            jnp.asarray(c1, jnp.float32), jnp.asarray(c2, jnp.float32),
            distance_threshold=thr))
        got = t_cvpm.cvpm_pair_mask(
            torch.as_tensor(anchor), torch.as_tensor(active),
            torch.as_tensor(c1, dtype=torch.float32),
            torch.as_tensor(c2, dtype=torch.float32),
            distance_threshold=thr).numpy()
        away = _margins(anchor, active, c1, c2, thr) > 1e-5
        assert away.mean() > 0.99, pair
        np.testing.assert_array_equal(got[away], want[away])
        hits += int(want.sum())
    assert hits > 50


def test_knn_curvature_matches_jax():
    rng = np.random.default_rng(0)
    flat = np.zeros((700, 3), np.float32)
    flat[:, :2] = rng.uniform(-1, 1, size=(700, 2))
    flat[:, 2] = rng.normal(size=700) * 0.02
    blob = rng.normal(size=(700, 3)).astype(np.float32) * 0.5 + 2.0
    pts = np.concatenate([flat, blob]).astype(np.float32)
    active = rng.uniform(size=len(pts)) < 0.9
    want = np.asarray(j_cvpm.knn_curvature(jnp.asarray(pts),
                                           jnp.asarray(active)))
    got = t_cvpm.knn_curvature(torch.as_tensor(pts),
                               torch.as_tensor(active)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.all(got[~active] == 1.0)
    below = want <= 0.1
    assert 0.2 < below.mean() < 0.8
    mask = t_cvpm.curvature_offset_mask(torch.as_tensor(pts),
                                        torch.as_tensor(active), K).numpy()
    away = np.repeat(np.abs(want - 0.1) > 1e-4, K)
    np.testing.assert_array_equal(mask[away],
                                  np.repeat(below, K)[away])
