"""The trainer of splatco_torch (train/loop.py), on the CPU.

Its host logic is held against a JAX `Trainer` built without `setup()`:
the view sequence one seed draws, the cached consistency gates (SSIM,
1e-5), the CVPM prune mask `_cvpm_and_densify` builds from them and the
kmax escalation controller.  The rest runs the port alone
on a toy Blender scene (6 views at 64x48): a resumed run equals the
straight one bit for bit across kmax escalations, densify calls, a graph
downsample, a capacity regrowth and a level activation; capacity
regrowth keeps the Adam moments; test PSNR rises and the densify events
land in metrics_log.
"""
import json
import logging
import os
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig)
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.scene import Scene
from splatco_torch.ops.knn import voxelize
from splatco_torch.train import loop as t_loop
from splatco_torch.train.checkpoint import params_to_numpy
from splatco_torch.train.cvpm import cvpm_pair_mask
from splatco_torch.train.loop import Trainer
from splatco_torch.utils.synthetic import write_blender_dataset
from splatco_tpu.config import ModelConfig as JModelConfig
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.config import PipelineConfig as JPipelineConfig
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.train import loop as j_loop
from splatco_tpu.train.loop import Trainer as JTrainer

# mixed resolutions, so the batch sort by size matters
SIZES = [(64, 48), (48, 64), (64, 48), (80, 40), (64, 48), (48, 64),
         (80, 40)]


def host_trainers(seed=3, mv=4, kmax=12):
    """A JAX and a port Trainer with only the host state set."""
    jt = JTrainer(JModelConfig(kmax=kmax), JOptimizationConfig(),
                  JPipelineConfig(mv=mv), backend="pallas", binning="packed")
    tt = Trainer(ModelConfig(kmax=kmax), OptimizationConfig(),
                 PipelineConfig(mv=mv), device="cpu")
    rng = np.random.default_rng(seed)
    eyes = rng.normal(size=(len(SIZES), 3)) + [0.0, 0.0, -3.0]
    jt.train_cams = [j_look_at(e, [0, 0, 0], [0, -1, 0], 1.0, 0.8, w, h,
                               uid=i)
                     for i, (e, (w, h)) in enumerate(zip(eyes, SIZES))]
    tt.train_cams = [look_at_camera(e, [0, 0, 0], [0, -1, 0], 1.0, 0.8, w,
                                    h, uid=i, device="cpu")
                     for i, (e, (w, h)) in enumerate(zip(eyes, SIZES))]
    for tr in (jt, tt):
        tr.py_rng = random.Random(seed)
        tr.viewpoint_stack = []
        tr._gate_cache = {}
        tr._clip_warned = False
        tr.logger = logging.getLogger("test_torch_trainer")
        tr.dev = torch.device("cpu")
    jt.kmax_pack, jt._kp_floor = 4, 1
    return jt, tt


def test_view_sequence_matches_jax():
    """Three epochs of camera batches: the same views, in the same order
    (sorted by resolution within a batch)."""
    jt, tt = host_trainers()
    n_batches = 3 * len(SIZES) // 4 + 1
    for _ in range(n_batches):
        want = [c.uid for c in jt._sample_cameras()]
        got = [c.uid for c in tt._sample_cameras()]
        assert got == want
    assert tt.viewpoint_stack == jt.viewpoint_stack


def test_pair_gates_match_jax():
    jt, tt = host_trainers()
    rng = np.random.default_rng(8)
    imgs = [np.clip(0.5 + 0.2 * rng.normal(size=(3, h, w)), 0, 1).astype(
        np.float32) for w, h in SIZES]
    for _ in range(3):
        jc, tc = jt._sample_cameras(), tt._sample_cameras()
        want = np.asarray(jt._pair_gates(
            jc, [jnp.asarray(imgs[c.uid]) for c in jc]))
        got = tt._pair_gates(tc, [torch.as_tensor(imgs[c.uid])
                                  for c in tc]).numpy()
        assert got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert set(tt._gate_cache) == set(jt._gate_cache)


class Marked(Exception):
    """Raised by a stand-in for `adjust_anchor` with the CVPM mask the
    trainer passed it."""

    def __init__(self, mask):
        super().__init__()
        self.mask = np.asarray(mask)


def stop_at_adjust(*args, **kwargs):
    raise Marked(args[8])


def cvpm_margins(anchor, active, pairs, thr):
    """float64 distance of each anchor's CVPM comparisons from their
    thresholds, the smallest over the view pairs `pairs` [(o1, o2)].  A
    batch may hold one view twice: that pair has no baseline and marks
    nothing (NaN distances), in both packages."""
    a = anchor.astype(np.float64)
    m = a[active]
    mean, std = m.mean(0), m.std(0, ddof=1)
    out = [np.abs(np.abs(a - mean) - 3.0 * std).min(axis=1)]
    for c1, c2 in pairs:
        if np.array_equal(c1, c2):
            continue
        for o, other in ((c1, c2), (c2, c1)):
            ray = (other - o) / np.linalg.norm(other - o)
            d = a - o
            proj = o + ray * (d @ ray)[:, None]
            out.append(np.abs(np.linalg.norm(a - proj, axis=1) - thr))
            out.append(np.abs(np.linalg.norm(d, axis=1) - 0.5))
    return np.min(out, axis=0)


@pytest.mark.parametrize("compat_t", [False, True])
def test_cvpm_mask_matches_jax(compat_t, monkeypatch):
    """`_cvpm_and_densify`'s CVPM part, up to the `adjust_anchor` call:
    the SSIM > 0.6 gate, the origins (camera centres, or the T vectors
    under cvpm_compat_T) and the threshold (the voxel size), held
    against the JAX Trainer's on the same anchors and camera batches.
    Even uids show one image (their pairs pass the gate), odd uids
    noise; anchors lie along the baselines of every pair, centres and
    T vectors both, so every wiring choice changes the mask."""
    monkeypatch.setattr(j_loop, "adjust_anchor", stop_at_adjust)
    monkeypatch.setattr(t_loop, "adjust_anchor", stop_at_adjust)
    jt, tt = host_trainers()
    rng = np.random.default_rng(5)
    base = rng.uniform(size=(3, 64, 80))
    imgs = [np.clip((base[:, :h, :w] + 0.02 * rng.normal(size=(3, h, w)))
                    if uid % 2 == 0 else rng.uniform(size=(3, h, w)), 0, 1
                    ).astype(np.float32)
            for uid, (w, h) in enumerate(SIZES)]
    thr, k = 0.04, jt.cfg.n_offsets
    jt.key = jax.random.key(0)
    tt.generator = torch.Generator().manual_seed(0)
    hits = gate_mattered = 0
    for batch in range(4):
        jc, tc = jt._sample_cameras(), tt._sample_cameras()
        assert [c.uid for c in tc] == [c.uid for c in jc]
        ends = {"centre": [np.asarray(c.camera_center, np.float64)
                           for c in jc],
                "T": [np.asarray(c.T, np.float64) for c in jc]}
        lines = []
        for o in ends.values():
            for i in range(4):
                for j in range(i + 1, 4):
                    u = rng.uniform(-0.2, 1.2, size=(60, 1))
                    lines.append(o[i] + u * (o[j] - o[i])
                                 + rng.normal(size=(60, 3)) * 0.03)
        cloud = rng.standard_t(3, size=(400, 3)) * 2.0
        anchor = np.concatenate(lines + [cloud]).astype(np.float32)
        active = rng.uniform(size=len(anchor)) < 0.9
        c = len(anchor)
        jt.cfg.cvpm_compat_T = tt.cfg.cvpm_compat_T = compat_t
        jt.params = {"anchors": {"anchor": jnp.asarray(anchor)}}
        jt.mstate = types.SimpleNamespace(active=jnp.asarray(active),
                                          voxel_size=thr)
        tt.params = {"anchors": {"anchor": torch.as_tensor(anchor)}}
        tt.mstate = types.SimpleNamespace(active=torch.as_tensor(active),
                                          voxel_size=thr)
        for tr in (jt, tt):
            tr.opt_state = tr.stats = None
        with pytest.raises(Marked) as want:
            jt._cvpm_and_densify(15, jc, [jnp.asarray(imgs[cam.uid])
                                          for cam in jc])
        with pytest.raises(Marked) as got:
            tt._cvpm_and_densify(15, tc, [torch.as_tensor(imgs[cam.uid])
                                          for cam in tc])
        want, got = want.value.mask, got.value.mask
        assert got.shape == want.shape == (c,)

        gates = np.asarray(jt._pair_gates(jc, [jnp.asarray(imgs[cam.uid])
                                               for cam in jc]))
        assert np.abs(gates - 0.6).min() > 1e-3
        pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
        o = ends["T" if compat_t else "centre"]
        gated = [(o[i], o[j]) for (i, j), g in zip(pairs, gates) if g > 0.6]
        away = cvpm_margins(anchor, active, gated, thr) > 1e-5
        assert away.mean() > 0.99, batch
        np.testing.assert_array_equal(got[away], want[away])
        hits += int(want.sum())
        # every pair, gate or not: the gate removes marks
        ungated = np.zeros(c, bool)
        for i, j in pairs:
            ungated |= cvpm_pair_mask(
                torch.as_tensor(anchor), torch.as_tensor(active),
                torch.as_tensor(o[i], dtype=torch.float32),
                torch.as_tensor(o[j], dtype=torch.float32),
                distance_threshold=thr).numpy()
        gate_mattered += int((ungated & ~want).sum())
    assert hits > 50 and gate_mattered > 50


@pytest.mark.parametrize("kmax,escalate,clips", [
    (12, True, [3, 0, 7, 5000, 5000]),   # 12 -> 24 -> 32, then warn once
    (4, True, [0, 0, 1]),                # no clip, no change; then 8
    (12, False, [5000, 5000]),           # escalation off: warn once
    (32, True, [999, 1001, 4000]),       # at the cap: the threshold
])
def test_kmax_escalation_matches_jax(kmax, escalate, clips):
    jt, tt = host_trainers(kmax=kmax)
    for tr in (jt, tt):
        tr.auto_kmax_escalate = escalate
    for nc in clips:
        jt._tune_kmax_pack({"num_clipped": nc, "num_overflow": 0,
                            "max_slots": 2})
        tt._escalate_kmax(nc)
        assert (tt.cfg.kmax, tt._clip_warned) == (jt.cfg.kmax,
                                                  jt._clip_warned)


# ----------------------------------------------------------------------
# the port on a toy scene
# ----------------------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    """Toy shapes run fastest on one thread, and the suite runs several
    workers side by side: torch's default of a thread per core makes
    them fight over the cores (4x slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy_blender"))
    write_blender_dataset(path, n_views=6, n_pts=150, width=64, height=48,
                          device="cpu")
    return path


def make_trainer(dataset, model_path, capacity=0, **kw):
    """kmax 1 escalates at the first flushes; the capacity, when given,
    is filled at init, so the first densify call regrows it."""
    cfg = ModelConfig(source_path=dataset, model_path=model_path,
                      feat_dim=8, n_offsets=4, voxel_size=0.05,
                      plane_size=32, num_channels=9, appearance_dim=0,
                      contractor=True, eval=True, kmax=1,
                      capacity=capacity)
    opt = OptimizationConfig(update_from=2, update_interval=3,
                             update_until=22, start_stat=1,
                             graph_downsampling_iters=[10])
    scene = Scene(cfg, shuffle=False, write_artifacts=False, device="cpu")
    tr = Trainer(cfg, opt, PipelineConfig(mv=2), device="cpu",
                 logger=logging.getLogger("test_torch_trainer"),
                 save_iterations=(), activation_iterations=(8,), **kw)
    tr.setup(scene, seed=7)
    return tr


def full_state(tr):
    """Every array of the training state a checkpoint saves, by path."""
    return params_to_numpy(tr._state_tree())


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def test_resume_is_bit_exact_and_psnr_rises(dataset, tmp_path):
    n = 12
    n_init = len(voxelize(Scene(ModelConfig(source_path=dataset),
                                device="cpu").points, 0.05))
    model_a = str(tmp_path / "a")
    tr_a = make_trainer(dataset, model_a, capacity=n_init,
                        test_iterations=(1, 2 * n),
                        checkpoint_iterations=(n,))
    log_a = tr_a.train(iterations=2 * n, progress_every=1000)

    with open(os.path.join(model_a, f"chkpnt{n}.json")) as fh:
        meta = json.load(fh)
    assert meta["kmax"] > 1                   # escalated before the save
    assert meta["capacity"] > n_init          # regrew before the save
    assert meta["activate_level"] == 1
    assert meta["kmax_pack"] is None and meta["class_spec"] is None
    events = [m for m in log_a if "densify_grown" in m]
    assert [m["iteration"] for m in events] == list(range(3, 22, 3))
    assert any(m["capacity_regrow"] for m in events if m["iteration"] < n)
    assert sum(m["densify_grown"] for m in events) > 0
    psnr = {m["iteration"]: m["test_psnr"] for m in log_a
            if "test_psnr" in m}
    assert psnr[2 * n] > psnr[1] + 1.0

    tr_c = make_trainer(dataset, model_a, test_iterations=(2 * n,),
                        checkpoint_iterations=())
    assert tr_c.restore() == n
    assert tr_c.cfg.kmax == meta["kmax"]
    tr_c.train(iterations=2 * n, progress_every=1000)

    want, got = full_state(tr_a), full_state(tr_c)
    assert sorted(got) == sorted(want)
    differ = [k for k in want if not same_bits(want[k], got[k])]
    assert not differ, differ[:10]
    assert (tr_c.cfg.kmax, tr_c.activate_level, tr_c.ema_loss,
            tr_c.viewpoint_stack, tr_c.py_rng.getstate()) == (
        tr_a.cfg.kmax, tr_a.activate_level, tr_a.ema_loss,
        tr_a.viewpoint_stack, tr_a.py_rng.getstate())
    assert tr_c.opt.densify_grad_threshold == tr_a.opt.densify_grad_threshold


def test_grow_preserves_adam_moments(dataset, tmp_path):
    """Capacity regrowth keeps every old moment and count bit for bit and
    zero-initialises only the new rows.  (The run checks its steps'
    determinism on the way, twice.)"""
    tr = make_trainer(dataset, "", test_iterations=(),
                      checkpoint_iterations=(), determinism_check=True,
                      determinism_every=2)
    tr.train(iterations=4, progress_every=1000)
    before = full_state(tr)
    cap = tr.params["anchors"]["anchor"].shape[0]
    tr._grow(cap * 2)
    after = full_state(tr)
    grown = 0
    for key, old in before.items():
        new = after[key]
        if old.shape == new.shape:
            assert same_bits(old, new), key
        else:
            grown += 1
            assert same_bits(old, new[:old.shape[0]]), key
            assert not new[old.shape[0]:].any(), key
    # params, mu and nu of the 6 anchor fields, 4 statistics, active
    assert grown == 3 * 6 + 4 + 1
    assert tr.params["anchors"]["anchor"].shape[0] == 2 * cap
    tr.train(iterations=6, progress_every=1000)
    assert all(np.isfinite(v).all() for v in full_state(tr).values()
               if v.dtype == np.float32)
