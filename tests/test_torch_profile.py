"""The port's profiling switches on the CPU: make_train_step(disable=...)
against JAX's step with the same blocks removed, the empty set bit for
bit the step as it was before the switch existed, what "optimizer" and
"stats" leave alone, train_torch.py --profile's trace and
tools/profile_step_recon_torch.py's JSON line.

Tolerances against JAX (q = 0, the JAX step's Pallas kernels in
interpret mode, the port's plain kernels): loss and l1 at 1e-5 relative,
as tests/test_torch_train_step.py holds the whole step; the first Adam
moments (0.1 x the gradient) per leaf, max-normalised, at 5e-4, the
rasterizer's gradient bound.
"""
import hashlib
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses_optim import flat_numpy
from test_torch_train_step import TERMS, port_inputs, toy_case

import train_torch
from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.splatco import init_model
from splatco_torch.train.checkpoint import params_to_numpy
from splatco_torch.train.optimizer import make_optimizer, opt_state_from_numpy
from splatco_torch.train.step import DISABLE, init_stats, make_train_step
from splatco_torch.utils.synthetic import write_colmap_dataset
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.train.optimizer import make_optimizer as j_make_optimizer
from splatco_tpu.train.step import init_stats as j_init_stats
from splatco_tpu.train.step import make_train_step as j_make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import profile_step_recon_torch  # noqa: E402

# every block but the optimizer: one JAX compile covers them all
COMBINED = frozenset({"ssim", "consistency", "tv", "sreg", "stats"})
# sha256 of one step's params, moments, statistics and losses, computed
# by `step_digest` with the step of the commit before `disable` existed,
# with the tri-plane sampler of ops/plane_sample.py in it (whose backward
# sums each texel's entries exactly, as int64 under a power-of-two scale)
# and the hand-written VJPs of the SSIM map (ops/losses.py) and of the
# EWA projection (ops/projection.py), each the same chain rule as
# autograd's through the formula, rounded in another order
DEFAULT_STEP_DIGEST = \
    "85b758adac2e94a7ac52772a2d8d2ee6b90e43d30a2b15263b588e5fbceb93e4"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_disable_matches_the_jax_step():
    case = toy_case()
    jcfg, params, state, cam_args, gts = case
    cams = tuple(j_look_at(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h, uid=i)
                 for i, (eye, fx, fy, w, h) in enumerate(cam_args))
    tx = j_make_optimizer(JOptimizationConfig(), params, 1.0, 0)
    jstep = j_make_train_step(jcfg, JOptimizationConfig(), mv=2,
                              activate_level=0, tx=tx, backend="pallas",
                              q_noise=0.0, disable=COMBINED)
    opt_state = tx.init(params)
    stats = j_init_stats(params["anchors"]["anchor"].shape[0],
                         jcfg.n_offsets)
    want = jax.tree.map(np.asarray, jstep(
        params, opt_state, state.active, state.contractor, stats, cams,
        gts, jnp.zeros(3), jax.random.key(0), jnp.int32(0),
        jnp.float32(TERMS["consistency_on"]), jnp.float32(TERMS["tv_w"]),
        jnp.float32(TERMS["stats_on"])))

    _, args = port_inputs(case, params, opt_state, stats)
    step = make_train_step(port_cfg(jcfg), OptimizationConfig(), 2, 0,
                           args_tx(args), q_noise=0.0, device="cpu",
                           disable=COMBINED)
    _, got_state, got_stats, got_m = step(*args)
    for name in ("loss", "l1"):
        np.testing.assert_allclose(float(got_m[name]), float(want[3][name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got_m["con"]) == float(want[3]["con"]) == 0.0
    # the statistics are the step's input, in both packages
    for f in ("opacity_accum", "anchor_demon", "offset_gradient_accum",
              "offset_denom"):
        assert torch.equal(getattr(got_stats, f), getattr(args[4], f))
        assert not np.asarray(getattr(want[2], f)).any()
    mu_want = opt_state_from_numpy(flat_numpy(want[1]), device="cpu")["mu"]
    got_mu, want_mu = params_to_numpy(got_state["mu"]), params_to_numpy(
        mu_want)
    assert sorted(got_mu) == sorted(want_mu)
    live = 0
    for key, w in want_mu.items():
        scale = np.abs(w).max()
        if scale > 0:
            live += 1
            assert np.abs(got_mu[key] - w).max() / scale < 5e-4, key
    assert live > 10


def port_cfg(jcfg):
    return ModelConfig(**{k: getattr(jcfg, k)
                          for k in ModelConfig.__dataclass_fields__})


def args_tx(args):
    return make_optimizer(OptimizationConfig(), args[0], 1.0, 0,
                          device="cpu")


def digest_case():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 0.4
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0, 0, 0],
                      scene_length=[2, 2, 2])
    params, state = init_model(cfg, pts, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    h, w = 48, 64
    cams = [look_at_camera(eye, [0, 0, 0], [0, -1, 0], 1.0, h / w, w, h,
                           uid=i, device="cpu")
            for i, eye in enumerate([[0, 0, -3], [0.5, 0.3, -2.8],
                                     [-0.4, 0.2, -3.1]])]
    gts = [torch.as_tensor(rng.uniform(size=(3, h, w)).astype(np.float32))
           for _ in cams]
    return cfg, params, state, cams, gts


def run_step(**kw):
    """One 3-view step (q = 0.03, every term on) of a seeded model from
    a fresh optimizer state and zero statistics: (inputs, outputs)."""
    cfg, params, state, cams, gts = digest_case()
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, 1.0, 0, device="cpu")
    inputs = (params, tx.init(params), state.active, state.contractor,
              init_stats(params["anchors"]["anchor"].shape[0],
                         cfg.n_offsets, device="cpu"),
              cams, gts, torch.zeros(3), torch.Generator().manual_seed(5),
              0, *TERMS.values())
    step = make_train_step(cfg, opt, 3, 0, tx, device="cpu", **kw)
    return inputs, step(*inputs)


def step_digest(out) -> str:
    p, o, s, m = out
    h = hashlib.sha256()
    tree = {"p": p, "o": {k: o[k] for k in ("mu", "nu")},
            "s": vars(s), "m": {k: m[k] for k in ("loss", "l1", "con")}}
    for k, v in sorted(params_to_numpy(tree).items()):
        h.update(k.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def test_empty_disable_is_the_step_bit_for_bit():
    assert list(TERMS.values()) == [1.0, 4e-7, 1.0]
    _, default = run_step()
    _, empty = run_step(disable=frozenset())
    assert step_digest(default) == step_digest(empty) == DEFAULT_STEP_DIGEST


def test_optimizer_and_stats_blocks_leave_their_state():
    inputs, (p, o, s, m) = run_step(disable=frozenset({"optimizer"}))
    assert p is inputs[0] and o is inputs[1]
    fresh = params_to_numpy(digest_case()[1])  # the same seeded init
    got = params_to_numpy(p)
    assert all(np.array_equal(got[k], v) for k, v in fresh.items())
    assert float(s.offset_denom.sum()) > 0  # the statistics still ran
    inputs, (p, o, s, m) = run_step(disable=frozenset({"stats"}))
    for f in ("opacity_accum", "anchor_demon", "offset_gradient_accum",
              "offset_denom"):
        assert not getattr(s, f).any(), f
    assert not torch.equal(p["anchors"]["feat"], inputs[0]["anchors"]["feat"])
    with pytest.raises(ValueError):
        make_train_step(digest_case()[0], OptimizationConfig(), 3, 0, None,
                        device="cpu", disable=frozenset({"planes"}))
    assert DISABLE == COMBINED | {"optimizer"}


def test_train_cli_profile_writes_a_trace(tmp_path, monkeypatch):
    """train_torch.py --profile in this process (TensorBoard hidden: its
    import alone takes ~15 s here)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    write_colmap_dataset(scene, n_views=6, n_pts=150, width=64, height=48,
                         device="cpu")
    train_torch.main(["-s", scene, "-m", model, "--device", "cpu",
                      "--feat_dim", "8", "--n_offsets", "4",
                      "--voxel_size", "0.05", "--plane_size", "32",
                      "--num_channels", "9", "--appearance_dim", "0",
                      "--contractor", "--iterations", "3", "--mv", "2",
                      "--test_iterations", "3", "--profile"])
    with open(os.path.join(model, "profile_trace", "trace.json")) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_profile_step_recon_prints_its_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = profile_step_recon_torch.main(["--device", "cpu", "--smoke"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["device"] == "cpu" and line["clock"] == "host"
    assert sorted(line["ms"]) == sorted(profile_step_recon_torch.VARIANTS)
    assert all(v > 0 for v in line["ms"].values())
    assert line["block_ms"]["optimizer"] == pytest.approx(
        line["ms"]["full"] - line["ms"]["-optimizer"])
