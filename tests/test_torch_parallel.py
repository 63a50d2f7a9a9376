"""The sharded SVC step of splatco_torch (parallel/) on the CPU: rank
processes over gloo (tests/_torch_parallel_worker.py, spawned by
`spawn` with the SPLATCO_* variables) against the JAX package's
`make_sharded_train_step` on the 2x2 submesh of the conftest's 8 CPU
devices.

The model is tests/test_parallel.py's (200 points, feat_dim 16, n_offsets
4, plane_size 64); JAX's initial params reach the ranks in an .npz.  One
spawn of four ranks runs every 2x2 case, so start-up is paid once; the
JAX step compiles in this process meanwhile.  Every step runs at q = 0
(the two packages' noise streams differ) with the consistency, TV and
statistics terms on.

Tolerances (tests/test_parallel.py's own): loss and l1 1e-5 relative;
params atol 2e-5, rtol 1e-4; anchor_demon and offset_denom exactly;
opacity_accum and offset_gradient_accum 1e-4 relative (of each one's
max).  Kernel path against dense under the sharded step (1x2 mesh,
64x64): loss and l1 1e-5, statistics atol 1e-4 rtol 1e-3, and each
leaf's gradient max-normalised 5e-4, the bound tests/test_rasterize_
pallas.py holds the JAX kernel backward to against the dense oracle.
The gradients are compared, not Adam's params: Adam's first update is
about lr * sign(g), so a gradient at rounding level flips an element by
2 lr (one anchor scaling did, by 0.014, at atol 2e-5).  In 16 px tiles
(SPLATCO_RASTER=v3) the sharded step's gradient is held to the
single-device step's (test_sharded_16px_tiles_match_single_device).
The sharded loop's per-step loss stays within 5e-3 of the single-device
trajectory (the limit of __graft_entry__.py's dryrun_multichip).
masked_batchnorm over a 2-rank group: 1e-6 of the single-process values.
"""
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parallel import build, place
from test_torch_losses_optim import flat_numpy

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.mlp import masked_batchnorm
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.models.contraction import Contractor
from splatco_torch.parallel import distributed, mesh as t_mesh
from splatco_torch.parallel.train_step import (make_sharded_train_step,
                                               pad_view_batch)
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import init_stats, make_train_step
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.data.cameras import strip_static
from splatco_tpu.parallel.mesh import make_mesh as j_make_mesh
from splatco_tpu.parallel.train_step import \
    make_sharded_train_step as j_make_sharded_train_step
from splatco_tpu.parallel.train_step import pad_view_batch as j_pad_batch
from splatco_tpu.parallel.train_step import stack_cameras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
TERMS = (1.0, 4e-7, 1.0)  # consistency_on, tv_w, stats_on
STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")
SPAWN_TIMEOUT = 240


def write_inputs(path, n_view, n_gauss, h=32, w=64):
    """test_parallel's model and views, as the worker reads them."""
    case = build(n_view, n_gauss, h, w)
    cfg, _, params, state, _, _, _, gts = case
    np.savez(path, cfg=json.dumps({k: getattr(cfg, k)
                                   for k in ModelConfig.__dataclass_fields__}),
             active=np.asarray(state.active),
             cmin=np.asarray(state.contractor.xyz_min),
             cmax=np.asarray(state.contractor.xyz_max),
             cenabled=state.contractor.enabled, gts=np.asarray(gts),
             **{f"p:{k}": v for k, v in flat_numpy(params).items()})
    return case


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(n, inputs, out_dir, explicit=False):
    """Run the worker as n gloo ranks with the SPLATCO_* variables, each
    rank's output in its own log; returns each rank's (json, npz)."""
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SPLATCO_", "JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT, SPLATCO_BACKEND="gloo",
               SPLATCO_COORDINATOR=f"localhost:{free_port()}",
               SPLATCO_NUM_PROCESSES=str(n))
    argv = [sys.executable, WORKER, str(inputs), str(out_dir)] + (
        ["--explicit"] if explicit else [])
    logs = [open(os.path.join(out_dir, f"rank{i}.log"), "w+")
            for i in range(n)]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=logs[i],
                              stderr=subprocess.STDOUT,
                              env=dict(env, SPLATCO_PROCESS_ID=str(i)))
             for i in range(n)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:  # a rank that fails makes the others' next collective fail
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {rank} exit {p.returncode}:\n" \
            f"{text[-4000:]}"
    out = []
    for rank in range(n):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            res = json.load(fh)
        out.append((res, dict(np.load(os.path.join(out_dir,
                                                   f"rank{rank}.npz")))))
    return out


def jax_sharded_step(case):
    """JAX's dense sharded step at q = 0 on the 2x2 submesh."""
    cfg, opt, params, state, tx, opt_state, cams, gts = case
    mesh = j_make_mesh(2, 2, jax.devices()[:4])
    params_s, active, stats_s = place(mesh, params, state, cfg)
    step = j_make_sharded_train_step(cfg, opt, mesh, tx, backend="dense",
                                     q_noise=0.0)
    p, _, st, m = step(params_s, opt_state, active, state.contractor,
                       stats_s, stack_cameras(cams), gts, jax.random.key(1),
                       *(jnp.float32(t) for t in TERMS))
    return {"loss": float(m["loss"]), "l1": float(m["l1"]),
            "params": flat_numpy(p),
            "stats": {f: np.asarray(getattr(st, f)) for f in STAT_FIELDS}}


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded4")
    case = write_inputs(tmp / "in.npz", 2, 2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, 4, tmp / "in.npz", tmp / "out")
        want = jax_sharded_step(case)
        return {"ranks": ranks.result(), "jax": want}


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded2")
    write_inputs(tmp / "in.npz", 1, 2, h=64, w=64)
    return {"env": spawn(2, tmp / "in.npz", tmp / "env"),
            "explicit": spawn(2, tmp / "in.npz", tmp / "explicit",
                              explicit=True)}


def check_params(got_arrays, prefix, want, atol=2e-5, rtol=1e-4):
    assert sorted(k[len(prefix):] for k in got_arrays
                  if k.startswith(prefix)) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got_arrays[prefix + key], w, atol=atol,
                                   rtol=rtol, err_msg=key)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------
# the 2x2 mesh against JAX's sharded step


def test_mesh_layout(runs4):
    for rank, (res, _) in enumerate(runs4["ranks"]):
        n_view, n_gauss, view, gauss, row, col = res["mesh"]
        assert (n_view, n_gauss) == (2, 2)
        assert (view, gauss) == divmod(rank, 2)
        assert row == [2 * view, 2 * view + 1]
        assert col == [gauss, gauss + 2]
        assert res["backend"] == "gloo"


def test_sharded_step_metrics_match_jax(runs4):
    want = runs4["jax"]
    for res, _ in runs4["ranks"]:
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["l1"], want["l1"], rtol=1e-5)


def test_sharded_step_params_match_jax(runs4):
    _, arrays = runs4["ranks"][0]
    check_params(arrays, "step.p:", runs4["jax"]["params"])


def test_sharded_step_stats_match_jax(runs4):
    _, arrays = runs4["ranks"][0]
    want = runs4["jax"]["stats"]
    for f in ("anchor_demon", "offset_denom"):
        np.testing.assert_array_equal(arrays[f"step.s:{f}"], want[f], f)
    assert want["offset_denom"].sum() > 0
    for f in ("opacity_accum", "offset_gradient_accum"):
        assert want[f].max() > 0
        assert rel_err(arrays[f"step.s:{f}"], want[f]) < 1e-4, f


def test_sharded_step_is_deterministic_across_ranks(runs4):
    """Two steps from one state repeat bit for bit on every rank, and the
    replicated leaves (params and Adam moments) are bit-identical on all
    four ranks after a step."""
    digests = set()
    for res, _ in runs4["ranks"]:
        assert res["repeat_identical"]
        digests.update(res["replicated_digests"])
    assert len(digests) == 1


def test_sharded_step_on_mixed_resolutions(runs4):
    """A 65x96 / 64x96 pair padded to one 128x96 canvas trains: finite
    loss, params moved, visibility counted."""
    for res, _ in runs4["ranks"]:
        assert res["mixed_canvas"] == [2, 3, 128, 96]
        assert np.isfinite(res["mixed_loss"]) and np.isfinite(res["mixed_l1"])
        assert res["mixed_moved"] > 0
        assert res["mixed_demon"] > 0


def test_sharded_loop_tracks_single_device(runs4):
    """24 steps with densify at 10 and 20 (growing anchors), a capacity
    regrowth at 10 (re-sharded, moments kept) and a level bump at 14,
    against the single-device trajectory that adopts the sharded state
    after each densify."""
    res = runs4["ranks"][0][0]
    sh = np.asarray(res["loop_losses_sharded"])
    sd = np.asarray(res["loop_losses_single"])
    assert len(sh) == len(sd) == 24 and np.all(np.isfinite(sh))
    assert np.max(np.abs(sh - sd) / np.abs(sd)) < 5e-3
    densify = res["loop_densify"]
    assert [d[0] for d in densify] == [10, 20]
    assert sum(d[1][0] for d in densify) > 0  # anchors grew
    for _, got, single in densify:  # same densify on the two states
        assert abs(got[2] - single[2]) <= max(8, 0.05 * single[2])
    first, second = res["loop_capacity"]
    assert first == second == 2 * 1024
    for other, _ in runs4["ranks"][1:]:
        assert other["loop_losses_sharded"] == res["loop_losses_sharded"]


def test_children_import_no_jax(runs4, runs2):
    for res, _ in runs4["ranks"] + runs2["env"] + runs2["explicit"]:
        assert res["modules"] == []


# ---------------------------------------------------------------------
# the 1x2 mesh: kernel path vs dense, environment vs arguments, BN


def test_sharded_kernel_path_matches_dense(runs2):
    for res, arrays in runs2["env"]:
        assert res["cuda_clipped"] == 0
        np.testing.assert_allclose(res["cuda_loss"], res["dense_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["cuda_l1"], res["dense_l1"],
                                   rtol=1e-5)
        dense = {k[len("dense.g:"):]: v for k, v in arrays.items()
                 if k.startswith("dense.g:")}
        assert len(dense) > 10
        for key, want in dense.items():
            got = arrays[f"cuda.g:{key}"]
            if np.abs(want).max() > 0:
                assert rel_err(got, want) < 5e-4, key
            else:  # a leaf the loss does not reach (an inactive level)
                np.testing.assert_array_equal(got, want, key)
        for f in STAT_FIELDS:
            np.testing.assert_allclose(arrays[f"cuda.s:{f}"],
                                       arrays[f"dense.s:{f}"], atol=1e-4,
                                       rtol=1e-3, err_msg=f)


def test_sharded_16px_tiles_match_single_device(runs2):
    """SPLATCO_RASTER=v3's configuration (16 px tiles, kmax 32) on 32 px
    strips, each two rows of tiles: the sharded step's gradient against
    the single-device step's on the whole view, with the offsets untied
    (equal depths in a tile order by slot rank, which a strip's clamped
    rect changes).  Both run the same kernel path, so only the order of
    sums differs: loss and l1 1e-5, each leaf 1.1e-6 of its max (the
    JAX kernels' gradient bound), the counts exactly and the
    accumulations 1e-6 of their max."""
    for res, arrays in runs2["env"]:
        assert res["cuda16_clipped"] == res["single16_clipped"] == 0
        np.testing.assert_allclose(res["cuda16_loss"], res["single16_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["cuda16_l1"], res["single16_l1"],
                                   rtol=1e-5)
        single = {k[len("single16.g:"):]: v for k, v in arrays.items()
                  if k.startswith("single16.g:")}
        assert len(single) > 10
        for key, want in single.items():
            got = arrays[f"cuda16.g:{key}"]
            if np.abs(want).max() > 0:
                assert rel_err(got, want) < 1.1e-6, key
            else:  # a leaf the loss does not reach (an inactive level)
                np.testing.assert_array_equal(got, want, key)
        for f in ("anchor_demon", "offset_denom"):
            np.testing.assert_array_equal(arrays[f"cuda16.s:{f}"],
                                          arrays[f"single16.s:{f}"], f)
        for f in ("opacity_accum", "offset_gradient_accum"):
            assert rel_err(arrays[f"cuda16.s:{f}"],
                           arrays[f"single16.s:{f}"]) < 1e-6, f


def test_init_from_environment_equals_explicit_arguments(runs2):
    for (env_res, env_arr), (arg_res, arg_arr) in zip(runs2["env"],
                                                      runs2["explicit"]):
        assert env_res["mesh"] == arg_res["mesh"] == [
            1, 2, 0, env_res["rank"], [0, 1], [env_res["rank"]]]
        assert env_res["cuda_loss"] == arg_res["cuda_loss"]
        assert sorted(env_arr) == sorted(arg_arr)
        for key in env_arr:
            np.testing.assert_array_equal(env_arr[key], arg_arr[key], key)


def test_masked_batchnorm_over_a_group(runs2):
    """BN over two ranks' rows equals single-process BN on the
    concatenated rows, forward and gradient."""
    rng = np.random.default_rng(11)
    x_all = rng.normal(size=(74, 5)).astype(np.float32) * 2.0 + 0.5
    mask_all = rng.uniform(size=74) < 0.7
    cot_all = rng.normal(size=(74, 5)).astype(np.float32)
    x = torch.as_tensor(x_all).requires_grad_()
    bn = {"scale": torch.linspace(0.5, 1.5, 5).requires_grad_(),
          "bias": torch.linspace(-0.2, 0.2, 5).requires_grad_()}
    y = masked_batchnorm(bn, x, torch.as_tensor(mask_all))
    (y * torch.as_tensor(cot_all)).sum().backward()
    ranks = [arrays for _, arrays in runs2["env"]]
    for name, want in (("bn.y", y.detach()), ("bn.dx", x.grad)):
        got = np.concatenate([r[name] for r in ranks])
        np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=1e-6)
    for name, want in (("bn.dscale", bn["scale"].grad),
                       ("bn.dbias", bn["bias"].grad)):
        got = ranks[0][name] + ranks[1][name]
        np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------
# in this process: the padding, the mesh factory, a 1x1 mesh


def test_pad_view_batch_matches_jax():
    rng = np.random.default_rng(5)
    dims = [(65, 96), (64, 96)]
    gts = [rng.uniform(size=(3, h, w)).astype(np.float32) for h, w in dims]

    def args(i, h, w):
        return ([np.sin(i), 0.3, -3.0], [0, 0, 0], [0, -1, 0], 1.0,
                1.0 * h / w, w, h)

    jcams = [strip_static(j_look_at(*args(i, h, w), uid=i))
             for i, (h, w) in enumerate(dims)]
    cam_stack, want_gts, want_geom = j_pad_batch(
        jcams, [jnp.asarray(g) for g in gts], 2)
    cams = [look_at_camera(*args(i, h, w), uid=i, device="cpu")
            for i, (h, w) in enumerate(dims)]
    cams_p, got_gts, got_geom = pad_view_batch(
        cams, [torch.as_tensor(g) for g in gts], 2)
    np.testing.assert_array_equal(got_gts.numpy(), np.asarray(want_gts))
    np.testing.assert_array_equal(got_geom.to(torch.float32).numpy(),
                                  np.asarray(want_geom))
    assert all((c.image_height, c.image_width)
               == (cam_stack.image_height, cam_stack.image_width)
               for c in cams_p)
    assert cams_p[1].fovx == cams[0].fovx


def test_rows_on_hosts_rules():
    """The counterpart of tests/test_multihost.py's factory errors: a rank
    count that does not match the mesh, a gauss axis across hosts, a
    gauss axis that does not divide a host's ranks."""
    distributed.check_rows_on_hosts(["a"] * 4 + ["b"] * 4, 4, 2)
    with pytest.raises(ValueError, match="!= 8 ranks"):
        distributed.check_rows_on_hosts(["a"] * 8, 4, 4)
    with pytest.raises(ValueError, match="spans hosts"):
        distributed.check_rows_on_hosts(["a", "b", "a", "b"], 2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        distributed.check_rows_on_hosts(["a"] * 3 + ["b"] * 3, 3, 2)


def test_init_distributed_without_variables_is_a_no_op(monkeypatch):
    for name in ("SPLATCO_COORDINATOR", "SPLATCO_NUM_PROCESSES",
                 "SPLATCO_PROCESS_ID", "SPLATCO_BACKEND",
                 *distributed.TORCHRUN_VARIABLES):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_from_torchrun_variables(monkeypatch):
    """With no SPLATCO_* variable set, torchrun's variables make the
    group (one gloo rank here), and the mesh factory takes it."""
    for name in ("SPLATCO_COORDINATOR", "SPLATCO_NUM_PROCESSES",
                 "SPLATCO_PROCESS_ID", "SPLATCO_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert distributed.init_distributed(device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        mesh = distributed.make_multihost_mesh(1, 1)
        assert (mesh.view, mesh.gauss, mesh.world.size) == (0, 0, 1)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture
def one_rank():
    """A process group of one gloo rank in this process, torn down
    after the test."""
    assert distributed.init_distributed(f"localhost:{free_port()}", 1, 0,
                                        device="cpu")
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_mesh_step_matches_single_device(one_rank):
    """The mesh factory refuses a size the world does not have; on a 1x1
    mesh the sharded step (dense) agrees with the single-device step."""
    with pytest.raises(ValueError, match="needs 4 ranks"):
        t_mesh.make_mesh(2, 2)
    with pytest.raises(ValueError):
        distributed.make_multihost_mesh(1, 2)
    mesh = distributed.make_multihost_mesh(1, 1)
    cfg_j, _, params_j, state, _, _, cams_j, gts = build(1, 1)
    cfg = ModelConfig(**{k: getattr(cfg_j, k)
                         for k in ModelConfig.__dataclass_fields__})
    params = params_from_numpy(flat_numpy(params_j), device="cpu")
    contractor = Contractor(
        xyz_min=torch.as_tensor(np.array(state.contractor.xyz_min)),
        xyz_max=torch.as_tensor(np.array(state.contractor.xyz_max)),
        enabled=state.contractor.enabled)
    active = torch.as_tensor(np.array(state.active))
    cam = look_at_camera([0.0, 0.3, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.5,
                         64, 32, device="cpu")
    gt = torch.as_tensor(np.array(gts[0]))
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, 1.0, 0, device="cpu")
    stats = init_stats(params["anchors"]["anchor"].shape[0], cfg.n_offsets,
                       device="cpu")
    sharded = make_sharded_train_step(cfg, opt, mesh, tx, backend="dense",
                                      q_noise=0.0, device="cpu")
    single = make_train_step(cfg, opt, 1, 0, tx, q_noise=0.0, device="cpu",
                             backend="dense")
    got = sharded(params, tx.init(params), active, contractor, stats, cam,
                  gt, 0, *TERMS)
    want = single(params, tx.init(params), active, contractor, stats, [cam],
                  [gt], torch.zeros(3), None, 0, *TERMS)
    np.testing.assert_allclose(float(got[3]["loss"]), float(want[3]["loss"]),
                               rtol=1e-6)
    for f in ("anchor_demon", "offset_denom"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f))
    for f in ("opacity_accum", "offset_gradient_accum"):
        assert rel_err(getattr(got[2], f), getattr(want[2], f)) < 1e-6


ENTRY_POINTS = {
    "make_sharded_train_step": lambda: make_sharded_train_step(
        ModelConfig(), OptimizationConfig(), None, None),
    "init_distributed": lambda: distributed.init_distributed(
        f"localhost:{free_port()}", 1, 0),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_card_unless_cpu_asked(entry, monkeypatch):
    """Without a card, the sharded step and the runtime called without
    device="cpu" raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry]()
    assert not torch.distributed.is_initialized()
