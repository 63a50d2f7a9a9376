"""The training slice of splatco_torch as a whole: its SVC step against
splatco_tpu's `make_train_step(backend="pallas")`, on the CPU.

Both steps run at q = 0 (the two packages' random streams differ), with
the consistency, TV and statistics terms on.  The JAX side runs its Pallas
kernels in interpret mode; the port runs its kernels' plain versions.  The
JAX steps are built and run once per module (each compiles for ~20 s).

Tolerances: loss and l1 at rel 1e-5, con at rel 1e-4 (a difference of two
renders, so relatively noisier); the statistics' counts exactly,
opacity_accum at 1e-5, the screen-space gradient norms max-normalised at
5e-4 (the rasterizer's gradient bound).  Params are compared after step 2,
taken from the JAX state after step 1: Adam's first update is about
lr * sign(g) (eps 1e-15), so a gradient at rounding level flips its update
by 2 lr, and step 1's params would test rounding, not the port.  Step 2's
params are held per leaf, max-normalised, to 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses_optim import flat_numpy, flat_torch
from test_train_step import build_toy

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.contraction import Contractor
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.train.optimizer import make_optimizer, opt_state_from_numpy
from splatco_torch.train.step import TrainStats, make_train_step
from splatco_tpu.config import ModelConfig as JModelConfig
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models.splatco import init_model as j_init_model
from splatco_tpu.train.optimizer import make_optimizer as j_make_optimizer
from splatco_tpu.train.step import init_stats as j_init_stats
from splatco_tpu.train.step import make_train_step as j_make_train_step

STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")
TERMS = dict(consistency_on=1.0, tv_w=4e-7, stats_on=1.0)


def build_mixed():
    """The mixed-resolution pair of tests/test_train_step.py."""
    pts = np.random.default_rng(1).normal(size=(200, 3)).astype(
        np.float32) * 0.4
    cfg = JModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05,
                       plane_size=32, num_channels=9, appearance_dim=0,
                       contractor=True, scene_center=[0, 0, 0],
                       scene_length=[2, 2, 2])
    params, state = j_init_model(jax.random.key(0), cfg, pts)
    cam_args = [([0, 0, -3], 1.0, 0.75, 64, 48),
                ([0.5, 0.3, -2.8], 1.0, 1.0, 96, 96)]
    gts = (jnp.full((3, 48, 64), 0.6), jnp.full((3, 96, 96), 0.4))
    return cfg, params, state, cam_args, gts


def toy_case():
    cfg, params, state, cams, gts = build_toy()
    h, w = 48, 64
    cam_args = [(eye, 1.0, 1.0 * h / w, w, h)
                for eye in ([0, 0, -3], [0.5, 0.3, -2.8])]
    return cfg, params, state, cam_args, tuple(gts)


def jax_steps(case, n_steps):
    """[(params, opt_state, stats, metrics)] after each of n_steps JAX
    steps, and the initial (params, opt_state, stats)."""
    cfg, params, state, cam_args, gts = case
    cams = tuple(j_look_at(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h, uid=i)
                 for i, (eye, fx, fy, w, h) in enumerate(cam_args))
    tx = j_make_optimizer(JOptimizationConfig(), params, 1.0, 0)
    step = j_make_train_step(cfg, JOptimizationConfig(), mv=2,
                             activate_level=0, tx=tx, backend="pallas",
                             q_noise=0.0)
    carry = (params, tx.init(params),
             j_init_stats(params["anchors"]["anchor"].shape[0],
                          cfg.n_offsets))
    out = [carry]
    for it in range(n_steps):
        res = step(*carry[:2], state.active, state.contractor, carry[2],
                   cams, gts, jnp.zeros(3), jax.random.key(it),
                   jnp.int32(it), jnp.float32(TERMS["consistency_on"]),
                   jnp.float32(TERMS["tv_w"]),
                   jnp.float32(TERMS["stats_on"]))
        out.append(jax.tree.map(np.asarray, res))
        carry = res[:3]
    return out


def port_inputs(case, params, opt_state, stats, tile16=None):
    """The port's step (q = 0) and its arguments, from JAX-side params,
    optax state and stats; `tile16` picks the rasterizer configuration."""
    jcfg, _, state, cam_args, gts = case
    cfg = ModelConfig(**{k: getattr(jcfg, k)
                         for k in ModelConfig.__dataclass_fields__})
    tparams = params_from_numpy(flat_numpy(params), device="cpu")
    tx = make_optimizer(OptimizationConfig(), tparams, 1.0, 0, device="cpu")
    tstate = opt_state_from_numpy(flat_numpy(opt_state), device="cpu")
    tstats = TrainStats(**{f: torch.as_tensor(np.array(getattr(stats, f)))
                           for f in STAT_FIELDS})
    contractor = Contractor(
        xyz_min=torch.as_tensor(np.array(state.contractor.xyz_min)),
        xyz_max=torch.as_tensor(np.array(state.contractor.xyz_max)),
        enabled=state.contractor.enabled)
    cams = [look_at_camera(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h, uid=i,
                           device="cpu")
            for i, (eye, fx, fy, w, h) in enumerate(cam_args)]
    step = make_train_step(cfg, OptimizationConfig(), 2, 0, tx,
                           q_noise=0.0, device="cpu", tile16=tile16)
    return step, (tparams, tstate, torch.as_tensor(np.array(state.active)),
                  contractor, tstats, cams,
                  [torch.as_tensor(np.array(g)) for g in gts],
                  torch.zeros(3), None, 0, TERMS["consistency_on"],
                  TERMS["tv_w"], TERMS["stats_on"])


def port_step(case, params, opt_state, stats, tile16=None):
    step, args = port_inputs(case, params, opt_state, stats, tile16)
    return step(*args)


@pytest.fixture(scope="module")
def toy_runs():
    case = toy_case()
    jx = jax_steps(case, 2)
    return {"case": case, "jax": jx,
            "port1": port_step(case, *jx[0]),
            "port2": port_step(case, *jx[1][:3])}


@pytest.fixture(scope="module")
def mixed_runs():
    case = build_mixed()
    jx = jax_steps(case, 1)
    return {"case": case, "jax": jx, "port1": port_step(case, *jx[0])}


def check_metrics(got, want):
    for name, rel in (("loss", 1e-5), ("l1", 1e-5), ("con", 1e-4)):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=rel, err_msg=name)
    assert float(want["con"]) > 0
    assert got["num_overflow"] == 0
    assert int(got["max_slots"]) == int(want["max_slots"])
    assert int(got["num_clipped"]) == int(want["num_clipped"])


def check_stats(got, want):
    for f in ("anchor_demon", "offset_denom"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.opacity_accum.numpy(),
                               np.asarray(want.opacity_accum), rtol=1e-5,
                               atol=1e-5)
    g = got.offset_gradient_accum.numpy().astype(np.float64)
    w = np.asarray(want.offset_gradient_accum, np.float64)
    assert w.max() > 0
    assert np.abs(g - w).max() / np.abs(w).max() < 5e-4


@pytest.mark.parametrize("step", [1, 2])
def test_step_metrics_match_jax(toy_runs, step):
    check_metrics(toy_runs[f"port{step}"][3], toy_runs["jax"][step][3])


@pytest.mark.parametrize("step", [1, 2])
def test_step_stats_match_jax(toy_runs, step):
    check_stats(toy_runs[f"port{step}"][2], toy_runs["jax"][step][2])


def test_step2_params_from_carried_state_match_jax(toy_runs):
    got = flat_torch(toy_runs["port2"][0])
    want = flat_numpy(toy_runs["jax"][2][0])
    before = flat_numpy(toy_runs["jax"][1][0])
    assert sorted(got) == sorted(want)
    moved = 0
    for key in want:
        g = got[key].numpy().astype(np.float64)
        w = want[key].astype(np.float64)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-12)
        assert err < 1e-3, (key, err)
        moved += int(not np.array_equal(w, before[key]))
    assert moved > 10


def test_step2_opt_state_counts_match_jax(toy_runs):
    got = toy_runs["port2"][1]
    want = opt_state_from_numpy(flat_numpy(toy_runs["jax"][2][1]),
                                device="cpu")
    for field in ("count", "sched_count"):
        assert {g: int(c) for g, c in got[field].items()} == \
            {g: int(c) for g, c in want[field].items()}


def test_mixed_size_views_match_jax(mixed_runs):
    check_metrics(mixed_runs["port1"][3], mixed_runs["jax"][1][3])
    check_stats(mixed_runs["port1"][2], mixed_runs["jax"][1][2])


def test_two_port_steps_are_bit_identical(toy_runs):
    again = port_step(toy_runs["case"], *toy_runs["jax"][1][:3])
    first = toy_runs["port2"]
    a, b = flat_torch(first[0]), flat_torch(again[0])
    assert all(torch.equal(a[k], b[k]) for k in a)
    for field in ("mu", "nu"):
        a, b = flat_torch(first[1][field]), flat_torch(again[1][field])
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(getattr(first[2], f), getattr(again[2], f))
               for f in STAT_FIELDS)
    assert torch.equal(first[3]["loss"], again[3]["loss"])


def test_step_leaves_inputs_unchanged(toy_runs):
    step, args = port_inputs(toy_runs["case"], *toy_runs["jax"][1][:3])
    tensors = {**flat_torch(args[0], "p"), **flat_torch(args[1], "o"),
               **{f: getattr(args[4], f) for f in STAT_FIELDS}}
    before = {k: v.clone() for k, v in tensors.items()}
    step(*args)
    assert all(torch.equal(tensors[k], before[k]) for k in tensors)
