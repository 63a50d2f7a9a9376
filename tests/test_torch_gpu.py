"""splatco_torch's CUDA kernels on the card (marker `gpu`; skipped where
there is no card), in both rasterizer configurations (32 px tiles, v2;
16 px tiles, v3).  These need no JAX, so they run on a machine without
it:  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The blend kernels are built with --fmad=false and repeat their plain
versions' float32 operations in the same order (a record a warp culls
changes nothing, and both sides use CUDA's expf), so the forwards equal
their plain versions bit for bit.  The backward's per-record sums over a
tile's 1024 pixels are taken in another order than the plain version's,
so each of its nine rows is held to 1e-5 of that row's largest |value|.
Both on random scenes and on crafted tiles (many record batches,
termination in the first batch, records grazing a warp's rectangle).  The probes (ops/probes.py)
add in their plain versions' order and are held to them exactly, the
alpha-sum probe to 1e-6 of the max (its library exp), the TF32 cumsum to
5e-4 of the max of a float64 cumsum (measured 1.9e-4; inputs rounded to
bf16 would give ~1.5e-3); the forward's ablation variants
(ops/raster_ablate.py) as the forward.  A small scene written to disk
and rendered by render_sets from a saved checkpoint equals the in-memory
model's render bit for bit.  The trainer (train/loop.py) trains a small
scene for 20 iterations with densify on the card, launching each kernel
once a view per step and the forward once an eval frame, and a run
resumed from its iteration-10 checkpoint ends bit for bit where the
straight run ended; a step with the context grids (use_spatial_ctx)
repeats bit for bit.  The evaluation metrics (FLIP, LPIPS) and RAFT agree
with the CPU on a small seeded pair.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig)
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.images import read_image
from splatco_torch.data.scene import Scene
from splatco_torch.eval import raft
from splatco_torch.eval.render_driver import render_sets
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops import (cuda_lib, flip, lpips, probes, raster_ablate,
                               raster_v3)
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import bin_frame, tile_grid
from splatco_torch.ops.rasterize_cuda import (BWD_KERNELS, BWD_WARP_RECT,
                                              FWD_KERNELS, FWD_WARP_RECT,
                                              raster_bwd,
                                              raster_bwd_plain, raster_fwd,
                                              raster_fwd_plain)
from splatco_torch.train.checkpoint import (params_to_numpy,
                                            save_model_checkpoint)
from splatco_torch.train.loop import Trainer
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import init_stats, make_train_step
from splatco_torch.utils.device import resolve_device
from splatco_torch.utils.math import round_up
from splatco_torch.utils.synthetic import (write_blender_dataset,
                                           write_colmap_dataset)

pytestmark = pytest.mark.gpu
BWD_TOL = 1e-5  # of each row's max |value|: pixel sums in another order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scene(n, h, w, seed, dev):
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    sx, sy, th = u(0.5, 10.0), u(0.5, 10.0), u(0.0, math.pi)
    c, s = torch.cos(th), torch.sin(th)
    a = c * c * sx * sx + s * s * sy * sy + 0.3
    b = c * s * (sx * sx - sy * sy)
    d = s * s * sx * sx + c * c * sy * sy + 0.3
    det = a * d - b * b
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(a, d)))
    proj = ProjectedCols(mx=u(-20, w + 20), my=u(-20, h + 20),
                         depth=u(1, 5), ca=d / det, cb=-b / det, cc=a / det,
                         radius=radius)
    return (ProjectedCols(*(t.to(dev) for t in proj)),
            torch.rand((n, 3), generator=g).to(dev), u(0.05, 0.99).to(dev))


def binned_scene(n, h, w, dev, tile16):
    """A random scene binned in the configuration: (binned, tiles_x,
    tiles_y, tile)."""
    proj, colors, opac = scene(n, h, w, n + h, dev)
    if tile16:
        tiles_x, tiles_y = raster_v3.tile_grid(h, w)
        return (raster_v3.bin_gaussians_v3(proj, colors, opac, tiles_x,
                                           tiles_y, kmax=32),
                tiles_x, tiles_y, raster_v3.TILE)
    tiles_x, tiles_y = tile_grid(h, w)
    return (bin_gaussians(proj, colors, opac, TILE, tiles_x, tiles_y),
            tiles_x, tiles_y, TILE)


def check_fwd_kernel(dev, n, h, w, tile16):
    binned, tiles_x, tiles_y, tile = binned_scene(n, h, w, dev, tile16)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    name = FWD_KERNELS[tile]
    before = cuda_lib.LAUNCHES[name]
    rgb, t_fin = raster_fwd(*args, tile=tile)
    assert cuda_lib.LAUNCHES[name] == before + 1
    assert rgb.shape == (3, tiles_y * tile, tiles_x * tile)
    p_rgb, p_t = raster_fwd_plain(*args, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(rgb, p_rgb) and torch.equal(t_fin, p_t)
    again, t_again = raster_fwd(*args, tile=tile)
    # no atomics: run to run identical
    assert torch.equal(rgb, again) and torch.equal(t_fin, t_again)


def check_bwd_kernel(dev, n, h, w, tile16):
    binned, tiles_x, tiles_y, tile = binned_scene(n, h, w, dev, tile16)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    rgb, t_fin = raster_fwd(*args, tile=tile)
    grad = torch.zeros_like(rgb)
    grad[:, :h, :w] = torch.randn((3, h, w), generator=torch.Generator()
                                  .manual_seed(n + w)).to(dev)
    bargs = args + (grad, rgb, t_fin,
                    torch.tensor([0.2, 0.3, 0.4], device=dev))
    name = BWD_KERNELS[tile]
    before = cuda_lib.LAUNCHES[name]
    got = raster_bwd(*bargs, tile=tile)
    assert cuda_lib.LAUNCHES[name] == before + 1
    want = raster_bwd_plain(*bargs, tile=tile)
    torch.cuda.synchronize()
    assert got.shape == want.shape == binned.records.shape
    if want.numel():
        scale = want.abs().amax(dim=1, keepdim=True)
        assert bool(((got - want).abs() <= BWD_TOL * scale).all())
        assert bool(scale.min() > 0)
    again = raster_bwd(*bargs, tile=tile)
    assert torch.equal(got, again)  # no atomics: run to run identical


@pytest.mark.parametrize("n,h,w", [(3000, 200, 300), (0, 64, 64),
                                   (500, 37, 70)])
def test_raster_fwd_kernel_matches_plain(card, n, h, w):
    check_fwd_kernel(card, n, h, w, tile16=False)


@pytest.mark.parametrize("n,h,w", [(3000, 200, 300), (0, 64, 64),
                                   (500, 37, 70)])
def test_raster_bwd_kernel_matches_plain(card, n, h, w):
    check_bwd_kernel(card, n, h, w, tile16=False)


# 80 x 112: the 16 px grid is 2 x the 32 px parents (8 x 6 tiles), wider
# than the image's ceil(size / 16)
@pytest.mark.parametrize("n,h,w", [(3000, 200, 300), (0, 64, 64),
                                   (500, 80, 112)])
def test_raster_fwd16_kernel_matches_plain(card, n, h, w):
    check_fwd_kernel(card, n, h, w, tile16=True)


@pytest.mark.parametrize("n,h,w", [(3000, 200, 300), (0, 64, 64),
                                   (500, 80, 112)])
def test_raster_bwd16_kernel_matches_plain(card, n, h, w):
    check_bwd_kernel(card, n, h, w, tile16=True)


def crafted_scene(kind, h, w, tile, dev):
    """Projected gaussians (proj, colors, opac) that stress the backward
    kernel's batches and its per-warp cull:
      deep:   700 faint gaussians around one spot, so a tile holds more
              than 3 batches of 128 records and pixels away from the spot
              stay live through all of them;
      opaque: 300 large opaque gaussians, so every pixel terminates in its
              tile's first batch and the later records keep zero rows;
      graze:  400 gaussians whose 1/255 contour touches an edge of a
              warp's rectangle (half BWD_WARP_RECT's, half FWD_WARP_RECT's)
              to within +-0.05 px."""
    rng = np.random.default_rng({"deep": 1, "opaque": 2, "graze": 3}[kind])
    n = {"deep": 700, "opaque": 300, "graze": 400}[kind]
    sx = rng.uniform(1.0, 4.0, n)
    sy = rng.uniform(1.0, 4.0, n)
    th = rng.uniform(0.0, np.pi, n)
    op = rng.uniform(0.02, 0.9, n)
    if kind == "deep":
        mx, my = rng.uniform(20, 28, n), rng.uniform(20, 28, n)
        op = rng.uniform(0.01, 0.03, n)
    elif kind == "opaque":
        sx, sy = rng.uniform(30, 40, n), rng.uniform(30, 40, n)
        mx, my = rng.uniform(0, w, n), rng.uniform(0, h, n)
        op = np.full(n, 0.99)
    c, s = np.cos(th), np.sin(th)
    sxx = c * c * sx * sx + s * s * sy * sy + 0.3
    sxy = c * s * (sx * sx - sy * sy)
    syy = s * s * sx * sx + c * c * sy * sy + 0.3
    if kind == "graze":
        # the extreme point of {d: d' cov^-1 d <= 2 t} along +-x or +-y,
        # t = log(255 op), put on a rectangle's edge, plus delta
        fwd = np.arange(n) % 2 == 1
        rw = np.where(fwd, FWD_WARP_RECT[tile][0], BWD_WARP_RECT[tile][0])
        rh = np.where(fwd, FWD_WARP_RECT[tile][1], BWD_WARP_RECT[tile][1])
        x0 = rng.integers(0, -(-w // rw), n) * rw
        y0 = rng.integers(0, -(-h // rh), n) * rh
        t = np.log(255.0 * op)
        delta = rng.uniform(-0.05, 0.05, n)
        side = rng.integers(0, 4, n)
        ex = np.sqrt(2 * t * sxx)          # x extent, and y at that point
        ey_at_x = sxy * np.sqrt(2 * t / sxx)
        ey = np.sqrt(2 * t * syy)
        ex_at_y = sxy * np.sqrt(2 * t / syy)
        xc = x0 + rng.uniform(0, rw - 1, n)
        yc = y0 + rng.uniform(0, rh - 1, n)
        mx = np.select([side == 0, side == 1, side == 2, side == 3],
                       [x0 + rw - 1 + ex + delta, x0 - ex - delta,
                        xc + ex_at_y, xc - ex_at_y])
        my = np.select([side == 0, side == 1, side == 2, side == 3],
                       [yc + ey_at_x, yc - ey_at_x,
                        y0 + rh - 1 + ey + delta, y0 - ey - delta])
    det = sxx * syy - sxy * sxy
    f = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    radius = np.ceil(3.0 * np.sqrt(np.maximum(sxx, syy)))
    proj = ProjectedCols(mx=f(mx), my=f(my), depth=f(rng.uniform(1, 5, n)),
                         ca=f(syy / det), cb=f(-sxy / det), cc=f(sxx / det),
                         radius=f(radius))
    return proj, f(rng.uniform(0, 1, (n, 3))), f(op)


@pytest.mark.parametrize("kind,h,w", [("deep", 64, 64),
                                      ("opaque", 70, 100),
                                      ("graze", 88, 120)])
@pytest.mark.parametrize("tile16", [False, True])
def test_raster_bwd_kernels_on_crafted_tiles(card, kind, h, w, tile16):
    """Both forward kernels (bit for bit) and both backward kernels
    (row-relative 1e-5) against their plain versions, and launch against
    launch (bit for bit), on tiles with more than 3 record batches, tiles
    that terminate in their first batch, and records grazing a warp's
    rectangle; ragged H x W."""
    tile = raster_v3.TILE if tile16 else TILE
    proj, colors, opac = crafted_scene(kind, h, w, tile, card)
    binned, tiles_x, tiles_y = bin_frame(proj, colors, opac, tile, h, w, 64)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    rgb, t_fin = raster_fwd(*args, tile=tile)
    rgb_again, t_again = raster_fwd(*args, tile=tile)
    p_rgb, p_t = raster_fwd_plain(*args, tile=tile)
    assert torch.equal(rgb, p_rgb) and torch.equal(t_fin, p_t)
    assert torch.equal(rgb, rgb_again) and torch.equal(t_fin, t_again)
    grad = torch.zeros_like(rgb)
    grad[:, :h, :w] = torch.randn((3, h, w), generator=torch.Generator()
                                  .manual_seed(7)).to(card)
    bargs = args + (grad, rgb, t_fin,
                    torch.tensor([0.2, 0.3, 0.4], device=card))
    got = raster_bwd(*bargs, tile=tile)
    again = raster_bwd(*bargs, tile=tile)
    want = raster_bwd_plain(*bargs, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert bool(scale.min() > 0)
    assert bool(((got - want).abs() <= BWD_TOL * scale).all())
    count = binned.tile_end - binned.tile_start
    if kind == "deep":
        assert int(count.max()) > 3 * 128
    if kind == "opaque":
        # every pixel terminated in the first batch: the records after it
        # were never staged and keep zero rows
        assert bool((t_fin[:h, :w] < 0.01).all()) and int(count.min()) > 128
        start = binned.tile_start.long()
        later = torch.cat([torch.arange(int(a) + 128, int(a) + int(c),
                                        device=card)
                           for a, c in zip(start, count)])
        assert not bool(got[:, later].any())


def toy_step(dev, tile16=None, use_spatial_ctx=False):
    """One SVC step (q = 0) of a small seeded model on `dev`."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0],
                      use_spatial_ctx=use_spatial_ctx)
    pts = np.random.default_rng(0).normal(size=(300, 3)).astype(
        np.float32) * 0.4
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(0))
    cams = [look_at_camera(e, [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48,
                           uid=i, device=dev)
            for i, e in enumerate([[0, 0, -3], [0.5, 0.3, -2.8]])]
    gts = [torch.full((3, 48, 64), v, device=dev) for v in (0.6, 0.4)]
    opt = OptimizationConfig()
    tx = make_optimizer(opt, params, 1.0, 0, device=dev)
    step = make_train_step(cfg, opt, 2, 0, tx, q_noise=0.0, device=dev,
                           tile16=tile16)
    return step(params, tx.init(params), state.active, state.contractor,
                init_stats(params["anchors"]["anchor"].shape[0],
                           cfg.n_offsets, device=dev),
                cams, gts, torch.zeros(3, device=dev), None, 0, 1.0, 4e-7,
                1.0)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if dataclasses.is_dataclass(tree):
        return leaves([getattr(tree, f.name)
                       for f in dataclasses.fields(tree)])
    return [tree]


def check_step(dev, tile16):
    """Each of the configuration's kernels launches once per view, two
    steps are bit-identical, and the loss equals the CPU's to 1e-4
    relative (matmul, exp and pixel sums round differently)."""
    tile = raster_v3.TILE if tile16 else TILE
    kernels = (FWD_KERNELS[tile], BWD_KERNELS[tile])
    cuda_lib.LAUNCHES.clear()
    first = toy_step(dev, tile16)
    assert dict(cuda_lib.LAUNCHES) == {name: 2 for name in kernels}
    second = toy_step(dev, tile16)
    for a, b in zip(leaves(first[:3]), leaves(second[:3])):
        assert torch.equal(a, b)
    cpu = toy_step(torch.device("cpu"), tile16)
    loss, want = float(first[3]["loss"]), float(cpu[3]["loss"])
    assert abs(loss - want) <= 1e-4 * abs(want)


def test_train_step_repeats_bit_for_bit_and_matches_cpu(card):
    check_step(card, tile16=False)


def test_v3_train_step_repeats_bit_for_bit_and_matches_cpu(card):
    check_step(card, tile16=True)


def probe_windows(dev):
    """[16, 8320] seeded data and starts at every residue of interest:
    the windows at p % 128 = 0 and 127, and the last one that fits."""
    data = torch.as_tensor(np.random.default_rng(1).normal(
        size=(probes.REC, 8320)).astype(np.float32), device=dev)
    starts = torch.tensor([0, 7, 127, 128, 255, 1000, 4096, 8063, 8064,
                           8191], dtype=torch.int32, device=dev)
    return data, starts


def launched(key, fn):
    before = cuda_lib.LAUNCHES[key]
    out = fn()
    assert cuda_lib.LAUNCHES[key] == before + 1
    return out


@pytest.mark.parametrize("mode", probes.EXTRACT_MODES)
def test_probe_extract_kernel_matches_plain(card, mode):
    data, starts = probe_windows(card)
    got = launched(f"{probes.EXTRACT}[{mode}]",
                   lambda: probes.extract_rows(data, starts, mode))
    assert torch.equal(got, probes.extract_rows_plain(data, starts))


@pytest.mark.parametrize("mode", probes.CUMSUM_MODES)
def test_probe_cumsum_kernel_matches_plain(card, mode):
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(128, 256)).astype(np.float32), device=card)
    got = launched(f"{probes.CUMSUM}[{mode}]",
                   lambda: probes.cumsum_rows(x, mode))
    ref = torch.cumsum(x.double(), dim=0)
    scale = float(ref.abs().max())
    if mode == "fp32":
        assert float((got - probes.cumsum_rows_plain(x)).abs().max()) \
            <= 1e-6 * scale
    else:  # TF32 inputs: 10 mantissa bits
        assert float((got.double() - ref).abs().max()) <= 5e-4 * scale


def test_probe_accum_kernel_is_in_place_and_two(card):
    out = torch.zeros((8, 128), device=card)
    ones = torch.ones_like(out)
    got = launched(probes.ACCUM, lambda: probes.accumulate_(out, ones))
    assert got.data_ptr() == out.data_ptr()
    assert bool((out == 2.0).all())


@pytest.mark.parametrize("extract", probes.BLEND_MODES)
def test_probe_blend_kernel_matches_plain(card, extract):
    data, starts = probe_windows(card)
    data[2] = data[2].abs()  # a negative row 2 overflows exp
    got = launched(f"{probes.BLEND}[extract={extract}]",
                   lambda: probes.alpha_sums(data, starts, extract))
    want = probes.alpha_sums_plain(data, starts, extract)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())


@pytest.mark.parametrize("variant", raster_ablate.VARIANTS)
def test_raster_fwd16_ablate_matches_plain(card, variant):
    binned, tiles_x, tiles_y, _ = binned_scene(3000, 200, 300, card, True)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, 200, 300)
    rgb, t_fin = launched(
        f"{raster_ablate.KERNEL}[{variant}]",
        lambda: raster_ablate.raster_fwd16_ablate(*args, variant=variant))
    p_rgb, p_t = raster_ablate.raster_fwd16_ablate_plain(*args, variant)
    assert float((rgb - p_rgb).abs().max()) <= 1e-5
    assert float((t_fin - p_t).abs().max()) <= 1e-5
    if variant in ("full", "nostage"):  # the production kernel's image
        want = raster_fwd(*args, tile=raster_v3.TILE)
        assert torch.equal(rgb, want[0]) and torch.equal(t_fin, want[1])


def test_render_sets_from_disk_matches_in_memory(card, tmp_path):
    """A small COLMAP scene on disk, a model initialised from its points
    and saved: render_sets launches the forward kernel once per frame, and
    its first test view (from the loaded checkpoint) is the in-memory
    model's render bit for bit, quantized as render_sets writes it."""
    scene = str(tmp_path / "scene")
    write_colmap_dataset(scene, n_views=9, n_pts=2000, width=160, height=96,
                         device=card)
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.02,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0], white_background=False,
                      source_path=scene, model_path=str(tmp_path / "model"))
    sc = Scene(cfg, shuffle=False, device=card)
    params, state = init_model(cfg, sc.points, device=card,
                               generator=torch.Generator().manual_seed(0))
    cap = round_up(int(state.active.sum()), 256)  # the capacity it loads at
    params["anchors"] = {k: v[:cap] for k, v in params["anchors"].items()}
    active = state.active[:cap]
    save_model_checkpoint(cfg.model_path, 5, params, active)
    cuda_lib.LAUNCHES.clear()
    _, n = render_sets(cfg, device=card)
    assert n == int(active.sum())
    assert dict(cuda_lib.LAUNCHES) == {FWD_KERNELS[TILE]: 9}
    cam = sc.test_cameras()[0]
    with torch.inference_mode():
        vis = prefilter_voxel(params["anchors"], active, cam)
        img = render(params, active, state.contractor, cam,
                     torch.zeros(3, device=card), visible_mask=vis,
                     activate_level=2, **decode_kwargs(cfg)).image
    want = (img.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255).astype(
        np.uint8)
    got = read_image(str(tmp_path / "model" / "test" / "ours_5" / "renders"
                         / "00000.png"))
    np.testing.assert_array_equal(got, want)


def test_spatial_ctx_step_repeats_bit_for_bit(card):
    first = toy_step(card, use_spatial_ctx=True)
    second = toy_step(card, use_spatial_ctx=True)
    for a, b in zip(leaves(first[:3]), leaves(second[:3])):
        assert torch.equal(a, b)
    assert torch.isfinite(first[3]["loss"])


def card_trainer(dev, scene, model_path, **kw):
    cfg = ModelConfig(source_path=scene, model_path=model_path, feat_dim=16,
                      n_offsets=4, voxel_size=0.05, plane_size=64,
                      num_channels=9, appearance_dim=0, contractor=True,
                      eval=True, kmax=2)
    opt = OptimizationConfig(update_from=2, update_interval=4,
                             update_until=18, start_stat=1,
                             graph_downsampling_iters=[9])
    tr = Trainer(cfg, opt, PipelineConfig(mv=2), device=dev,
                 save_iterations=(), activation_iterations=(6,), **kw)
    tr.setup(Scene(cfg, shuffle=False, write_artifacts=False, device=dev),
             seed=3)
    return tr


def test_trainer_on_the_card_resumes_bit_for_bit(card, tmp_path):
    """20 iterations with densify, a graph downsample, a level activation
    and kmax escalation: the launches are exact, test PSNR rises, and a
    run resumed from the iteration-10 checkpoint equals the straight run
    bit for bit."""
    scene = str(tmp_path / "scene")
    write_blender_dataset(scene, n_views=8, n_pts=400, width=128,
                          height=96, device=card)
    model = str(tmp_path / "model")
    straight = card_trainer(card, scene, model, test_iterations=(1, 20),
                            checkpoint_iterations=(10,))
    cuda_lib.LAUNCHES.clear()
    log = straight.train(iterations=20, progress_every=1000)
    frames = 2 * (len(straight.scene.test_cameras())
                  + len(straight.train_cams[5:30:5]))
    assert dict(cuda_lib.LAUNCHES) == {FWD_KERNELS[TILE]: 2 * 20 + frames,
                                       BWD_KERNELS[TILE]: 2 * 20}
    assert any("densify_grown" in m for m in log)
    psnr = [m["test_psnr"] for m in log if "test_psnr" in m]
    assert psnr[1] > psnr[0]
    resumed = card_trainer(card, scene, model, test_iterations=(),
                           checkpoint_iterations=())
    assert resumed.restore() == 10
    resumed.train(iterations=20, progress_every=1000)
    want = params_to_numpy(straight._state_tree())
    got = params_to_numpy(resumed._state_tree())
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].tobytes() == got[key].tobytes(), key
    assert resumed.cfg.kmax == straight.cfg.kmax


def test_eval_metrics_and_raft_on_the_card_match_the_cpu(card):
    """FLIP, LPIPS (VGG16 widths, seeded weights) and RAFT (seeded
    weights, 2 iterations) on a small seeded pair, card against CPU, at
    chip_smoke.py phase 17's tolerances: FLIP 1e-5, LPIPS 1e-4 relative,
    the flow 2e-3 x max(|flow|, 1).  Full float32 on both (resolve_device
    turns cuDNN's TF32 off)."""
    resolve_device(card)
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 128, 192)).astype(np.float32)
    b = np.clip(np.roll(a, 3, axis=2)
                + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
                    np.float32)
    pair = {dev: (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
            for dev in ("cpu", card)}
    got = {dev: float(flip.ldr_flip(*p)) for dev, p in pair.items()}
    assert abs(got["cpu"] - got[card]) <= 1e-5, got
    w = lpips.random_weights(0)
    got = {dev: float(lpips.lpips(
        {k: torch.from_numpy(v).to(dev) for k, v in w.items()}, *p))
        for dev, p in pair.items()}
    assert abs(got[card] / got["cpu"] - 1) <= 1e-4, got
    params = raft.init_raft_params(torch.Generator().manual_seed(0),
                                   device="cpu")
    flows = {dev: raft.make_flow_fn(params, iters=2, device=dev)(
        p[0].permute(1, 2, 0), p[1].permute(1, 2, 0)).cpu()
        for dev, p in pair.items()}
    assert flows[card].shape == (128, 192, 2)
    scale = max(float(flows["cpu"].abs().max()), 1.0)
    assert float((flows[card] - flows["cpu"]).abs().max()) <= 2e-3 * scale
