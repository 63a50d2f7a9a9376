"""The inference decode's CUDA graph (models/decode_graph.py).

On the CPU: the graph declines on CPU tensors, under autograd, with
quantization noise drawn from a generator and with a `group`, and there
`generate_neural_gaussians` returns what it returned before the graph
existed (`parent_decode`, a verbatim copy of it), bit for bit, counting an
eager decode and no capture or replay; the conditions one by one; the
key; the launch counts a capture records apart; the benchmark's reader of
the replay span.

On the card (marker `gpu`; no JAX, so they run where it is missing:
python -m pytest --noconftest -m gpu tests/test_torch_decode_graph.py):
replayed frames equal eager ones bit for bit (eager: under
`torch.enable_grad()`, where the graph declines) on 8 orbit cameras at
levels 0 and 2 in both rasterizer configurations, and with the context
grids, the feature bank and the distance inputs; a kept `RenderOutput`
is not overwritten by the next frame; an update of a plane in place is
replayed without a capture; parameters allocated anew bring one eager
decode, then a capture, and no stale replay; the appearance embedding
keys the graph on the camera; the wrappers' launch counts grow under
replay as they do eagerly; freeing the anchors frees the graph.
"""
import gc
import importlib.util
import math
import socket
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100.harness import trace as T
from bench_h100.harness.cell import WINDOW_RANGE
from splatco_torch.config import ModelConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models import decode_graph
from splatco_torch.models import decoders as dec
from splatco_torch.models.context_grid import spatial_ctx
from splatco_torch.models.renderer import (anchor_plane_coords,
                                           generate_neural_gaussians,
                                           prefilter_voxel, render)
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.models.triplane import feature_planes_forward
from splatco_torch.ops import cuda_lib, plane_sample
from splatco_torch.parallel.collectives import make_group
from splatco_torch.parallel.distributed import init_distributed
from splatco_torch.train.optimizer import tree_leaves
from splatco_torch.utils.math import normalize

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "plain": {},
    "wide": dict(appearance_dim=8, use_feat_bank=True, add_opacity_dist=True,
                 add_cov_dist=True, add_color_dist=True),
    "spatial_ctx": dict(use_spatial_ctx=True),
}
OUTPUTS = ("xyz", "color", "opacity", "scaling", "rot", "neural_opacity",
           "mask")


def parent_decode(params, contractor, camera, visible_mask, *,
                  activate_level, add_opacity_dist=False, add_cov_dist=False,
                  add_color_dist=False, appearance_dim=0,
                  use_feat_bank=False, compat_raw_domain=False,
                  use_spatial_ctx=False, plane_feats=None, q_noise=0.0,
                  generator=None, group=None):
    """`generate_neural_gaussians` as it was before the graph, verbatim
    but for the profiler span."""
    anchors = params["anchors"]
    anchor = anchors["anchor"]
    feat = anchors["feat"]
    offsets = anchors["offsets"]
    c, k, _ = offsets.shape
    grid_scaling = torch.exp(anchors["scaling"])

    xyz_norm = anchor_plane_coords(params, contractor, compat_raw_domain)
    if use_spatial_ctx:
        g_fea = tuple(spatial_ctx(xyz_norm, feat, -2.0, 2.0, level=i,
                                  mask=visible_mask)
                      for i in range(activate_level + 1))
    else:
        g_fea = torch.cat([feat, anchor, offsets.reshape(c, -1),
                           grid_scaling], dim=1)
    geo_fea = feature_planes_forward(
        params["planes"], xyz_norm, g_fea, visible_mask,
        activate_level=activate_level, plane_feats=plane_feats, q=q_noise,
        generator=generator, group=group)

    ob_view = anchor - camera.camera_center
    ob_dist = torch.linalg.vector_norm(ob_view, dim=1, keepdim=True)
    ob_view = ob_view / torch.clamp_min(ob_dist, 1e-12)

    if use_feat_bank:
        bank_w = dec.feature_bank_mlp(
            params["decoders"], torch.cat([ob_view, ob_dist], dim=1)
        )[:, None, :]  # [C,1,3]
        f = feat[:, :, None]
        feat = (f[:, ::4, :1].repeat(1, 4, 1) * bank_w[:, :, :1]
                + f[:, ::2, :1].repeat(1, 2, 1) * bank_w[:, :, 1:2]
                + f[:, ::1, :1] * bank_w[:, :, 2:]).squeeze(-1)

    cat_local = torch.cat([feat, ob_view, ob_dist, geo_fea], dim=1)
    cat_local_wod = torch.cat([feat, ob_view, geo_fea], dim=1)

    neural_opacity = dec.opacity_mlp(
        params["decoders"],
        cat_local if add_opacity_dist else cat_local_wod
    ).reshape(-1)  # [C*K]
    mask = (neural_opacity > 0.0) & visible_mask.repeat_interleave(k)
    opacity = torch.where(mask, neural_opacity, 0.0)

    color_in = cat_local if add_color_dist else cat_local_wod
    if appearance_dim > 0:
        app = dec.appearance_embedding(params["decoders"], camera.uid, c)
        color_in = torch.cat([color_in, app], dim=1)
    color = dec.color_mlp(params["decoders"], color_in).reshape(c * k, 3)

    scale_rot = dec.cov_mlp(
        params["decoders"], cat_local if add_cov_dist else cat_local_wod
    ).reshape(c * k, 7)

    def rep(a):
        return a[:, None].expand(c, k, a.shape[1]).reshape(c * k, -1)

    scaling_rep = rep(grid_scaling)  # [C*K,6]
    anchor_rep = rep(anchor)
    scaling = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = normalize(scale_rot[:, 3:7], eps=1e-12)
    xyz = anchor_rep + offsets.reshape(c * k, 3) * scaling_rep[:, :3]
    return {
        "xyz": xyz, "color": color, "opacity": opacity, "scaling": scaling,
        "rot": rot, "neural_opacity": neural_opacity, "mask": mask,
    }


def small_model(dev, n_pts=400, **flags):
    """(config, params, state) of a small seeded model on `dev`."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, contractor=True,
                      scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0],
                      **{"appearance_dim": 0, **flags})
    pts = np.random.default_rng(0).normal(size=(n_pts, 3)).astype(
        np.float32) * 0.4
    params, state = init_model(cfg, pts, device=dev, num_cameras=8,
                               generator=torch.Generator().manual_seed(0))
    return cfg, params, state


def orbit(n, dev, width=96, height=64):
    return [look_at_camera([3.0 * math.sin(2 * math.pi * i / n), 0.4,
                            -3.0 * math.cos(2 * math.pi * i / n)],
                           [0, 0, 0], [0, -1, 0], 1.0,
                           1.0 * height / width, width, height, uid=i,
                           device=dev)
            for i in range(n)]


def stats():
    return {k: decode_graph.STATS[k] for k in ("eager", "captures",
                                               "replays")}


def decode_both(cfg, params, state, cam, seed=None, **kw):
    """(the decode, the parent's decode) with the same arguments, each
    with a generator seeded by `seed` where one is given; the decode must
    count one eager decode."""
    vis = prefilter_voxel(params["anchors"], state.active, cam)
    args = (params, state.contractor, cam, vis)
    flags = dict(decode_kwargs(cfg), activate_level=2, **kw)

    def generator():
        if seed is not None:
            flags["generator"] = torch.Generator().manual_seed(seed)
        return flags

    before = stats()
    got = generate_neural_gaussians(*args, **generator())
    assert stats() == dict(before, eager=before["eager"] + 1)
    return got, parent_decode(*args, **generator())


def assert_same(got, want):
    assert set(got) == set(OUTPUTS) == set(want)
    for k in OUTPUTS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_declines_on_the_cpu(config):
    cfg, params, state = small_model("cpu", **CONFIGS[config])
    with torch.inference_mode():
        got, want = decode_both(cfg, params, state, orbit(1, "cpu")[0])
    assert_same(got, want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_declines_under_grad(config):
    """Under autograd the decode and its gradients are the parent's."""
    cfg, params, state = small_model("cpu", **CONFIGS[config])
    leaves = [params["planes"]["grids"][0]["xy"],
              params["decoders"]["color"][0]["w"], params["anchors"]["feat"]]
    for t in leaves:
        t.requires_grad_(True)
    got, want = decode_both(cfg, params, state, orbit(2, "cpu")[1])
    assert_same(got, want)

    def grads(out):
        loss = sum((out[k].float() * (i + 1)).sum()
                   for i, k in enumerate(OUTPUTS[:6]))
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(got), grads(want)):
        assert torch.equal(a, b)


def test_declines_with_noise_from_a_generator():
    cfg, params, state = small_model("cpu")
    with torch.no_grad():
        got, want = decode_both(cfg, params, state, orbit(1, "cpu")[0],
                                seed=7, q_noise=0.03)
    assert_same(got, want)
    assert not torch.equal(got["color"], decode_both(
        cfg, params, state, orbit(1, "cpu")[0])[0]["color"])


def test_declines_with_a_group():
    """One gloo rank in this process: the BatchNorm sums go through the
    group's all-gather."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert init_distributed(f"localhost:{port}", 1, 0, device="cpu")
    try:
        group = make_group("gauss", [0], None)
        cfg, params, state = small_model("cpu")
        with torch.no_grad():
            got, want = decode_both(cfg, params, state,
                                    orbit(1, "cpu")[0], group=group)
    finally:
        torch.distributed.destroy_process_group()
    assert_same(got, want)


@pytest.mark.parametrize("grad, q_noise, generator, group, plane_feats, want",
                         [(False, 0.0, None, None, None, True),
                          (False, 0.03, None, None, None, True),
                          (False, 0.0, "gen", None, None, True),
                          (True, 0.0, None, None, None, False),
                          (False, 0.03, "gen", None, None, False),
                          (False, 0.0, None, "group", None, False),
                          (False, 0.0, None, None, "feats", False)])
def test_engages_only_where_a_graph_repeats_the_decode(
        grad, q_noise, generator, group, plane_feats, want):
    on_card = types.SimpleNamespace(is_cuda=True)
    with torch.set_grad_enabled(grad):
        assert decode_graph.engages(on_card, q_noise, generator, group,
                                    plane_feats) is want
        assert not decode_graph.engages(torch.zeros(3), q_noise, generator,
                                        group, plane_feats)


def test_key():
    """Equal for the same tensors and inputs' layout, also after an
    update in place; another for tensors allocated anew, another input
    shape or another value."""
    _, params, state = small_model("cpu")
    cams = orbit(2, "cpu")
    inputs = (state.active, cams[0].camera_center)

    def key(p, inp=inputs, *values):
        return decode_graph.key_of(tree_leaves(p), inp, *(values or (2,)))

    want = key(params)
    assert key(params, (state.active.clone(), cams[1].camera_center)) == want
    params["planes"]["grids"][0]["xy"].mul_(2.0)
    assert key(params) == want
    assert key(dict(params, anchors={k: v.clone() for k, v in
                                     params["anchors"].items()})) != want
    assert key(params, (state.active[:-1], inputs[1])) != want
    assert key(params, inputs, 1) != want
    assert key(params, inputs, 2, 3) != want


def test_captured_launches_are_kept_apart_until_replayed():
    before = cuda_lib.LAUNCHES["k"]
    other = threading.Thread(target=cuda_lib.count_launch, args=("k",))
    with cuda_lib.captured_launches() as launches:
        cuda_lib.count_launch("k")
        cuda_lib.count_launch("k")
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert dict(launches) == {"k": 2}
    assert cuda_lib.LAUNCHES["k"] == before + 1  # the other thread's
    cuda_lib.count_launch("k")
    cuda_lib.count_replay(launches)
    cuda_lib.count_replay(launches)
    assert cuda_lib.LAUNCHES["k"] == before + 6


def share_reader():
    path = ROOT / "bench_h100" / "metrics" / "decode_graph_share.render.py"
    spec = importlib.util.spec_from_file_location("decode_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traced(kind, host, units=3):
    return T.Window([("k", 0, 10)], [], [(WINDOW_RANGE, 0, 10_000), *host],
                    1e-5, units, [[0]] * units, {}, kind=kind)


@pytest.mark.parametrize("replayed, want", [((), 0.0), ((0,), 100 / 3),
                                            ((0, 1, 2), 100.0)])
def test_share_reader(replayed, want):
    """Three frames' decodes (the second one's split across two threads,
    as merged host spans are), `decode_graph` inside the replayed ones."""
    decodes = [("decode", 0, 1_000), ("decode", 3_000, 3_500),
               ("decode", 3_400, 4_000), ("decode", 6_000, 7_000)]
    graph = [("decode_graph", s + 100, s + 200)
             for i, s in enumerate((0, 3_000, 6_000)) if i in replayed]
    assert share_reader()(traced("render", decodes + graph)) == \
        pytest.approx(want)


def test_share_reader_finds_nothing_outside_rendered_decodes():
    read = share_reader()
    assert read(traced("train", [("decode", 0, 1_000)])) is None
    assert read(traced("render", [("render", 0, 1_000)])) is None
    assert read(traced("render", [("decode", 0, 1_000)], units=0)) is None


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def frame(params, state, cfg, cam, level, tile16=None):
    vis = prefilter_voxel(params["anchors"], state.active, cam)
    return render(params, state.active, state.contractor, cam,
                  torch.zeros(3, device=cam.camera_center.device),
                  visible_mask=vis, activate_level=level, kmax=cfg.kmax,
                  tile16=tile16, **decode_kwargs(cfg))


def eager_frame(*args, **kw):
    """A frame the graph declines: autograd on."""
    with torch.enable_grad():
        return frame(*args, **kw)


def assert_frames_equal(got, want):
    for name in ("image", "neural_opacity", "selection_mask", "scaling",
                 "radii", "visibility_filter", "max_slots", "num_clipped"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.num_pairs == want.num_pairs


@pytest.mark.gpu
@pytest.mark.parametrize("config, level, tile16", [
    ("plain", 0, False), ("plain", 2, False), ("plain", 0, True),
    ("plain", 2, True), ("spatial_ctx", 2, False), ("wide", 1, False)])
def test_replayed_frames_equal_eager(card, config, level, tile16):
    flags = dict(CONFIGS[config])
    flags.pop("appearance_dim", None)  # keyed on the camera: never replays
    cfg, params, state = small_model(card, n_pts=3000, **flags)
    cams = orbit(8, card)
    eager = [eager_frame(params, state, cfg, c, level, tile16) for c in cams]
    before = stats()
    with torch.inference_mode():
        for _ in range(2):
            for c, want in zip(cams, eager):
                assert_frames_equal(frame(params, state, cfg, c, level,
                                          tile16), want)
    torch.cuda.synchronize()
    assert stats() == {"eager": before["eager"] + 2,
                       "captures": before["captures"] + 1,
                       "replays": before["replays"] + 14}


@pytest.mark.gpu
def test_a_kept_frame_is_not_overwritten(card):
    cfg, params, state = small_model(card, n_pts=3000)
    cams = orbit(4, card)
    with torch.inference_mode():
        frame(params, state, cfg, cams[0], 2)
        frame(params, state, cfg, cams[1], 2)  # captured
        replays = decode_graph.STATS["replays"]
        kept = frame(params, state, cfg, cams[2], 2)
        copy = kept._replace(**{k: getattr(kept, k).clone() for k in (
            "image", "neural_opacity", "selection_mask", "scaling", "radii",
            "visibility_filter")})
        frame(params, state, cfg, cams[3], 2)
    torch.cuda.synchronize()
    assert decode_graph.STATS["replays"] == replays + 2
    assert_frames_equal(kept, copy)


@pytest.mark.gpu
def test_an_update_in_place_is_replayed(card):
    cfg, params, state = small_model(card, n_pts=3000)
    cams = orbit(3, card)
    with torch.inference_mode():
        for c in cams:
            frame(params, state, cfg, c, 2)
    captures = decode_graph.STATS["captures"]
    replays = decode_graph.STATS["replays"]
    with torch.no_grad():
        params["planes"]["grids"][0]["xy"].mul_(1.5)
        params["decoders"]["color"][0]["w"].add_(0.01)
        got = frame(params, state, cfg, cams[0], 2)
    assert decode_graph.STATS["captures"] == captures
    assert decode_graph.STATS["replays"] == replays + 1
    assert_frames_equal(got, eager_frame(params, state, cfg, cams[0], 2))


@pytest.mark.gpu
def test_parameters_allocated_anew_are_captured_anew(card):
    cfg, params, state = small_model(card, n_pts=3000)
    cams = orbit(3, card)
    with torch.inference_mode():
        for c in cams:
            frame(params, state, cfg, c, 2)
    anew = {"anchors": params["anchors"], "decoders": params["decoders"],
            "planes": dict(params["planes"], grids=[
                {k: v * 1.25 for k, v in g.items()}
                for g in params["planes"]["grids"]])}
    wants = [eager_frame(anew, state, cfg, c, 2) for c in cams]
    steps = []
    with torch.inference_mode():
        for c, want in zip(cams, wants):
            before = stats()
            assert_frames_equal(frame(anew, state, cfg, c, 2), want)
            after = stats()
            steps.append(tuple(after[k] - before[k] for k in before))
    # (eager, captures, replays): one eager decode, then a capture (its
    # warm-up eager), then a replay
    assert steps == [(1, 0, 0), (1, 1, 0), (0, 0, 1)]


@pytest.mark.gpu
def test_the_appearance_embedding_keys_on_the_camera(card):
    cfg, params, state = small_model(card, n_pts=3000, appearance_dim=8)
    cams = orbit(4, card)
    before = stats()
    with torch.inference_mode():
        for c in cams:
            frame(params, state, cfg, c, 2)
        assert stats()["captures"] == before["captures"]
        for _ in range(3):
            got = frame(params, state, cfg, cams[1], 2)
    assert stats()["captures"] == before["captures"] + 1
    assert stats()["replays"] == before["replays"] + 1
    assert_frames_equal(got, eager_frame(params, state, cfg, cams[1], 2))


@pytest.mark.gpu
def test_launches_grow_under_replay_as_they_do_eagerly(card):
    cfg, params, state = small_model(card, n_pts=3000)
    cams = orbit(5, card)
    cuda_lib.LAUNCHES.clear()
    for c in cams:
        eager_frame(params, state, cfg, c, 2)
    eager = dict(cuda_lib.LAUNCHES)
    cuda_lib.LAUNCHES.clear()
    with torch.inference_mode():
        for c in cams:
            frame(params, state, cfg, c, 2)
    assert dict(cuda_lib.LAUNCHES) == eager
    assert eager[plane_sample.FWD_KERNEL] == 5 * 12  # every level, TPA


@pytest.mark.gpu
def test_freeing_the_anchors_frees_the_graph(card):
    cfg, params, state = small_model(card, n_pts=3000)
    cams = orbit(2, card)
    with torch.inference_mode():
        for c in cams:
            frame(params, state, cfg, c, 2)
    assert decode_graph._graph is not None
    del params
    gc.collect()
    assert decode_graph._graph is None
