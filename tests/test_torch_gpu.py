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
add in their plain versions' order and are held to them exactly (the
alpha-sum probe and the fp32 cumsum with NaN where the plain version is
NaN: both take libdevice's expf, and the cumsum's NaN are L's zeros
times a later inf or NaN; the accumulation on views 0-3 floats into
larger buffers, in place, refusing views that overlap; the row sums on
windows below 0, past the width, rows not 16 B aligned), the TF32 cumsum
with NaN and inf at the plain version's positions and elsewhere to 5e-4
of the max of a float64 cumsum (measured 1.9e-4; inputs rounded to bf16
would give ~1.5e-3); the forward's ablation variants
(ops/raster_ablate.py) as the forward.  A small scene written to disk
and rendered by render_sets from a saved checkpoint equals the in-memory
model's render bit for bit.  The trainer (train/loop.py) trains a small
scene for 20 iterations with densify on the card, launching each kernel
once a view per step and the forward once an eval frame, and a run
resumed from its iteration-10 checkpoint ends bit for bit where the
straight run ended; a step with the context grids (use_spatial_ctx)
repeats bit for bit.  The evaluation metrics (FLIP, LPIPS) and RAFT agree
with the CPU on a small seeded pair.  The tri-plane sampler's kernels
(ops/plane_sample.py) equal their plain versions bit for bit, the
forward and all three gradients (the plain version sums the same
integers), and two backward launches agree bit for bit.  The binning
kernels (ops/binning.py) and the slot reduce (ops/rasterize.py) equal
their plain versions bit for bit, bin_place as each segment's keys (its
atomics choose their order), the slot map only under the slot mask (the
card leaves it unfilled elsewhere; `binning.binning_diff`), on a random
scene, a tile longer than a sorting block's 4,096 keys, a tile of more
than two 16,384-key chunks (the long path's merge in more than one
round) and an empty scene, in both configurations.  SSIM's kernels
(ops/losses.py: the one-launch separable blur, the map forward and its
VJP) equal their plain versions bit for bit on small seeded images, sizes
that are no multiple of the blur's tiles, H or W below the window, a 1x1
image and NaN and infinite pixels, the blur also at 1, 3 and 31 taps, and
so do `ssim` and `masked_ssim` with their gradients; every training step
above launches them once a view and once a consistency pair's gate
forward and once a view backward, and the trainer once an eval frame;
the cotangent a step sends back to the map is dense.  The EWA
projection's kernels (ops/projection.py: the forward, full and radius
only, and the hand-written VJP) equal their plain versions bit for bit
on chip_smoke.py's crafted rows (NaN and inf included; det == 0 under a
singular view) and a seeded scene, with the render's five cotangents,
all six, zeros, none and seeded ones zeroed on the culled rows (as a
step sends them), and the backward also at ragged sizes on rows that
are views 1 and 3 rows into larger tensors; a training step projects in
three launches a
view (the prefilter's and the render's forward, one backward) and its
result equals the same step through the plain versions bit for bit.
"""
import collections
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from chip_smoke import (ACCUM_OFFSETS, ACCUM_SIZES, ACCUM_STEP_COUNTS,
                        PROJ_RAGGED_N, PROJ_VIEW_OFFSETS, accum_case,
                        accum_differs, accum_overlaps, blend_cases,
                        culled_cotangents, cumsum_cases, cumsum_differs,
                        extract_cases, same_floats_or_nan, tools_on_path)
from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig)
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.images import read_image
from splatco_torch.data.scene import Scene
from splatco_torch.eval import raft
from splatco_torch.eval.render_driver import render_sets
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs, init_model
from splatco_torch.ops import (binning, cuda_lib, flip, lpips, plane_sample,
                               probes, raster_ablate, raster_v3)
from splatco_torch.ops import losses
from splatco_torch.ops import projection
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import (REDUCE_KERNEL, bin_frame,
                                         reduce_slots, reduce_slots_plain,
                                         tile_grid)
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
BINNING = (*binning.KERNELS, REDUCE_KERNEL)


def ssim_launches(fwd: int, bwd: int) -> dict:
    """SSIM's kernels for `fwd` forwards (a blur and a map each) and `bwd`
    backwards (a map VJP and a blur each)."""
    return {losses.BLUR_KERNEL: fwd + bwd, losses.MAP_FWD_KERNEL: fwd,
            losses.MAP_BWD_KERNEL: bwd}


def projection_launches(views: int, backwards: int) -> dict:
    """The projection's kernels for `views` rendered views (each a
    prefilter's radius-only forward and a render's forward) and
    `backwards` render backwards."""
    out = {projection.FWD_KERNEL: 2 * views}
    if backwards:
        out[projection.BWD_KERNEL] = backwards
    return out
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
    """Each of the configuration's blend kernels launches once per view
    and each sampler kernel once per plane (level 0 and its TPA planes),
    two steps are bit-identical, and the loss equals the CPU's to 1e-4
    relative (matmul, exp and pixel sums round differently)."""
    tile = raster_v3.TILE if tile16 else TILE
    kernels = (FWD_KERNELS[tile], BWD_KERNELS[tile])
    cuda_lib.LAUNCHES.clear()
    first = toy_step(dev, tile16)
    # SSIM: one a view and one for the pair's gate forward, one a view
    # backward; the projection: 3 launches a view
    assert dict(cuda_lib.LAUNCHES) == {**{name: 2 for name in kernels},
                                       plane_sample.FWD_KERNEL: 6,
                                       plane_sample.BWD_KERNEL: 6,
                                       **{name: 2 for name in BINNING},
                                       **ssim_launches(3, 2),
                                       **projection_launches(2, 2)}
    second = toy_step(dev, tile16)
    for a, b in zip(leaves(first[:3]), leaves(second[:3])):
        assert torch.equal(a, b)
    cpu = toy_step(torch.device("cpu"), tile16)
    loss, want = float(first[3]["loss"]), float(cpu[3]["loss"])
    assert abs(loss - want) <= 1e-4 * abs(want)


def test_train_step_sends_the_map_a_dense_cotangent(card, monkeypatch):
    """Every cotangent a training step sends back to the SSIM map on the
    card is dense and contiguous, so `ssim_map_bwd` copies nothing."""
    seen = []
    bwd = losses.ssim_map_bwd

    def recording(g, stack):
        seen.append((g.stride(), g.is_contiguous()))
        return bwd(g, stack)

    monkeypatch.setattr(losses, "ssim_map_bwd", recording)
    toy_step(card, tile16=False)
    print(f"the map's cotangents' strides in a step: {seen}")
    assert seen == [((3 * 48 * 64, 48 * 64, 64, 1), True)] * 2


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


@pytest.mark.parametrize("mode", probes.EXTRACT_MODES)
def test_probe_extract_kernel_cases(card, mode):
    """chip_smoke's cases (the tool's windows, the kernel scale's 8,192,
    edge windows, below 0, at or past the width, one window, rows that
    are not 16 B aligned, data 4 B past a 16 B boundary): bit for bit,
    one launch a call."""
    tools_on_path()
    import micro_mosaic_torch as mm
    for case, (data, starts) in extract_cases(mm.inputs(), card).items():
        got = launched(f"{probes.EXTRACT}[{mode}]",
                       lambda: probes.extract_rows(data, starts, mode))
        assert torch.equal(got, probes.extract_rows_plain(data, starts)), \
            case


@pytest.mark.parametrize("mode", probes.CUMSUM_MODES)
def test_probe_cumsum_kernel_matches_plain(card, mode):
    """fp32 bit for bit with the plain version; TF32 (10 mantissa bits an
    input) to 5e-4 of a float64 cumsum's max."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(128, 256)).astype(np.float32), device=card)
    got = launched(f"{probes.CUMSUM}[{mode}]",
                   lambda: probes.cumsum_rows(x, mode))
    if mode == "fp32":
        assert same_floats_or_nan(got, probes.cumsum_rows_plain(x))
    assert cumsum_differs(got, x, mode) is None


@pytest.mark.parametrize("mode", probes.CUMSUM_MODES)
def test_probe_cumsum_kernel_cases(card, mode):
    """chip_smoke's cases (the tool's xs, inf, -inf and NaN rows, seeded
    shapes up to 1024 rows, a misaligned x) and [128, 65,536]: fp32 bit
    for bit, NaN where the plain version is NaN; TF32 NaN and inf at its
    positions, 5e-4 of the max elsewhere; one launch a call."""
    tools_on_path()
    import micro_mosaic_torch as mm
    cases = cumsum_cases(mm.inputs(), card)
    cases["scale"] = torch.as_tensor(np.random.default_rng(5).normal(
        size=(128, 65536)).astype(np.float32), device=card)
    for case, x in cases.items():
        got = launched(f"{probes.CUMSUM}[{mode}]",
                       lambda: probes.cumsum_rows(x, mode))
        assert cumsum_differs(got, x, mode) is None, case


def test_probe_accum_refuses_overlapping_views(card):
    """Views that share bytes raise before any launch."""
    for out, inp in accum_overlaps(card):
        before = cuda_lib.LAUNCHES[probes.ACCUM]
        with pytest.raises(ValueError, match="overlap"):
            probes.accumulate_(out, inp)
        assert cuda_lib.LAUNCHES[probes.ACCUM] == before


def test_probe_accum_kernel_is_in_place_and_two(card):
    out = torch.zeros((8, 128), device=card)
    ones = torch.ones_like(out)
    got = launched(probes.ACCUM, lambda: probes.accumulate_(out, ones))
    assert got.data_ptr() == out.data_ptr()
    assert bool((out == 2.0).all())


@pytest.mark.parametrize("offsets", ACCUM_OFFSETS)
@pytest.mark.parametrize("n", ACCUM_SIZES)
def test_probe_accum_kernel_matches_plain(card, n, offsets):
    """Seeded views starting 0-3 floats into larger buffers (16 B vectors
    after a head where in and out agree modulo 16 B, else element by
    element), at 0, 1, 4 and 5 steps: bit for bit, in place, the buffer
    around the view untouched, one launch a call."""
    for steps in ACCUM_STEP_COUNTS:
        out, inp = accum_case(n, offsets, 7 * n + steps, card)
        assert launched(probes.ACCUM,
                        lambda: accum_differs(out, inp, steps)) == []


@pytest.mark.parametrize("extract", probes.BLEND_MODES)
def test_probe_blend_kernel_matches_plain(card, extract):
    data, starts = probe_windows(card)
    data[2] = data[2].abs()  # a negative row 2 overflows exp
    got = launched(f"{probes.BLEND}[extract={extract}]",
                   lambda: probes.alpha_sums(data, starts, extract))
    assert same_floats_or_nan(got,
                              probes.alpha_sums_plain(data, starts, extract))


@pytest.mark.parametrize("extract", probes.BLEND_MODES)
def test_probe_blend_kernel_cases(card, extract):
    """chip_smoke's cases (the tool's raw inputs with their inf and NaN
    sums, row 2 made positive, edge windows, starts below 0 and at or
    past the width, one window): bit for bit, NaN where the plain version
    is NaN, one launch a call."""
    tools_on_path()
    import micro_mosaic_torch as mm
    for case, (data, starts) in blend_cases(mm.inputs(), card).items():
        got = launched(f"{probes.BLEND}[extract={extract}]",
                       lambda: probes.alpha_sums(data, starts, extract))
        want = probes.alpha_sums_plain(data, starts, extract)
        assert same_floats_or_nan(got, want), case


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
    # 9 frames, each sampling 12 planes (every level, TPA)
    assert dict(cuda_lib.LAUNCHES) == {FWD_KERNELS[TILE]: 9,
                                       plane_sample.FWD_KERNEL: 9 * 12,
                                       **{name: 9 for name in
                                          binning.KERNELS},
                                       **projection_launches(9, 0)}
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
    # the sampler: 6 planes a step and an eval frame at level 0
    # (iterations 1-6), 9 at level 1
    planes = 6 * 6 + 9 * 14
    assert dict(cuda_lib.LAUNCHES) == {
        FWD_KERNELS[TILE]: 2 * 20 + frames, BWD_KERNELS[TILE]: 2 * 20,
        plane_sample.FWD_KERNEL: planes + frames // 2 * (6 + 9),
        plane_sample.BWD_KERNEL: planes,
        **{name: 2 * 20 + frames for name in binning.KERNELS},
        REDUCE_KERNEL: 2 * 20,
        # SSIM: a view a step, a gate a camera pair (cached), an eval frame
        **ssim_launches(2 * 20 + len(straight._gate_cache) + frames,
                        2 * 20),
        # the projection: a prefilter and a render a view and an eval frame
        **projection_launches(2 * 20 + frames, 2 * 20)}
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


@pytest.mark.parametrize("case", ["in_range", "off_plane", "one_point"])
def test_plane_sample_kernels_match_plain(card, case):
    """The sampler's kernels against their plain versions on a 70x110
    plane (R 5), strided coordinate columns as `_split_coords` gives
    them: rows inside the plane, partly off it, or 90 % at one point
    (one texel tile's entries cut across many of the backward's
    blocks)."""
    n = 20_000
    rng = np.random.default_rng(8)
    plane = torch.tensor(rng.normal(size=(5, 70, 110)).astype(np.float32),
                         device=card)
    uv = rng.uniform(-1.5 if case == "off_plane" else -1.0, 1.0, (n, 3))
    if case == "one_point":
        uv[:int(0.9 * n)] = (0.123, -0.4567, 0.0)
    uv = torch.tensor(uv.astype(np.float32), device=card)
    u, v = uv[:, 0], uv[:, 1]
    g = torch.tensor(rng.normal(size=(n, 5)).astype(np.float32),
                     device=card)
    before = collections.Counter(cuda_lib.LAUNCHES)
    out = plane_sample.plane_sample_fwd(plane, u, v)
    want_out = plane_sample.plane_sample_fwd_plain(plane, u, v)
    assert torch.equal(out.view(torch.int32), want_out.view(torch.int32))
    got = plane_sample.plane_sample_bwd(g, u, v, plane)
    again = plane_sample.plane_sample_bwd(g, u, v, plane)
    want = plane_sample.plane_sample_bwd_plain(g, u, v, plane)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    launched = cuda_lib.LAUNCHES - before
    assert launched == {plane_sample.FWD_KERNEL: 1,
                        plane_sample.BWD_KERNEL: 2}


def test_plane_sample_bwd_nonfinite_cotangent(card):
    """A NaN in g makes d_plane NaN everywhere, bit for bit as the plain
    version does; the coordinates' gradients agree row by row."""
    rng = np.random.default_rng(9)
    plane = torch.tensor(rng.normal(size=(5, 70, 110)).astype(np.float32),
                         device=card)
    uv = torch.tensor(rng.uniform(-1.2, 1.2, (5000, 3)).astype(np.float32),
                      device=card)
    g = torch.tensor(rng.normal(size=(5000, 5)).astype(np.float32),
                     device=card)
    g[17, 3] = float("nan")
    got = plane_sample.plane_sample_bwd(g, uv[:, 0], uv[:, 1], plane)
    want = plane_sample.plane_sample_bwd_plain(g, uv[:, 0], uv[:, 1], plane)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def binning_scene(case, dev):
    """(proj, colors, opacities, h, w): a random scene, gaussians in one
    tile (depth ties; "hot": longer than a sorting block's 4,096 keys,
    "long": than two 16,384-key chunks), none, a random scene on a grid
    of more tiles than bin_count counts in shared memory (61,440 32 px
    tiles, 245,760 16 px ones), or chip_smoke.py's crafted mixed warps
    (`mixed_warp_inputs`: radius-0 rows beside rects far wider than kmax,
    4,133 rows, torch's NaN rules on some; "one": its first row, a
    clipped rect; "n33": its first 33)."""
    if case in ("mixed", "kmax40", "one", "n33"):
        from chip_smoke import mixed_warp_inputs
        proj, colors, opac, _, h, w, _ = mixed_warp_inputs(21, dev, False,
                                                           12)
        keep = {"one": 1, "n33": 33}.get(case, proj.mx.shape[0])
        return (ProjectedCols(*(t[:keep] for t in proj)), colors[:keep],
                opac[:keep], h, w)
    g = torch.Generator().manual_seed(21)
    n = {"random": 20000, "hot": 6000, "long": 40000, "empty": 0,
         "wide": 200000}[case]

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    h, w = (7680, 8192) if case == "wide" else (200, 328)
    if case in ("hot", "long"):
        mx, my, rad = u(36.0, 44.0), u(36.0, 44.0), torch.full((n,), 3.0)
        ca, cb, cc = torch.full((n,), 0.4), u(-0.05, 0.05), torch.full(
            (n,), 0.4)
    else:
        sig = u(0.5, 9.0)
        mx, my, rad = u(-20.0, w + 20.0), u(-20.0, h + 20.0), torch.ceil(
            3 * sig)
        ca, cb, cc = 1 / sig ** 2, torch.zeros(n), 1 / sig ** 2
    proj = ProjectedCols(mx=mx, my=my, depth=torch.round(u(1, 3) * 20) / 20,
                         ca=ca, cb=cb, cc=cc, radius=rad)
    return (ProjectedCols(*(t.to(dev) for t in proj)),
            torch.rand((n, 3), generator=g).to(dev), u(0.05, 0.99).to(dev),
            h, w)


@pytest.mark.parametrize("tile16", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("case", ["random", "hot", "long", "empty", "wide",
                                  "mixed", "kmax40", "one", "n33"])
def test_binning_kernels_match_plain(card, case, tile16):
    """bin_count, bin_place, bin_sort_tiles and slot_reduce against their
    plain versions bit for bit (the slot map under the mask), each
    launched twice, once a call; "kmax40" at kmax 40, where one
    gaussian's slots span more than one warp round of 32."""
    proj, colors, opac, h, w = binning_scene(case, card)
    tile = raster_v3.TILE if tile16 else TILE
    kmax = 40 if case == "kmax40" else 32 if tile16 else 12
    tiles_x, tiles_y = (raster_v3.tile_grid if tile16 else tile_grid)(h, w)
    geo = (tile, tiles_x, tiles_y, kmax, tile16)
    assert (tiles_x * tiles_y > binning.SHARED_TILES) == (case == "wide")
    before = collections.Counter(cuda_lib.LAUNCHES)
    want = binning.bin_count_plain(proj, opac, *geo)
    start, end, stats = want
    pairs, longest = stats[2:].tolist()
    want_keys = binning.bin_place_plain(proj, opac, start, pairs, *geo)
    want_out = binning.bin_sort_tiles_plain(want_keys, start, end, proj,
                                            colors, opac, kmax)
    per_rec = torch.randn((9, pairs), generator=torch.Generator(
        device=card).manual_seed(3), device=card)
    per_rec[:, ::4] = -0.0
    want_sums = reduce_slots_plain(per_rec, want_out.slot_pos,
                                   want_out.slot_mask)
    for _ in range(2):
        for a, b in zip(binning.bin_count(proj, opac, *geo), want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        keys = binning.bin_place(proj, opac, start, pairs, *geo)
        assert torch.equal(binning.sort_segments_plain(keys, start, end),
                           binning.sort_segments_plain(want_keys, start, end))
        out = binning.bin_sort_tiles(keys, start, end, longest, proj, colors,
                                     opac, kmax)
        assert binning.binning_diff(out, want_out) == []
        sums = reduce_slots(per_rec, out.slot_pos, out.slot_mask)
        assert torch.equal(sums.view(torch.int32),
                           want_sums.view(torch.int32))
    assert cuda_lib.LAUNCHES - before == {name: 2 for name in BINNING}
    if case in ("hot", "long"):
        assert longest == {"hot": 6000, "long": 40000}[case]
    got = bin_frame(proj, colors, opac, tile, h, w, kmax)[0]
    plain = binning.bin_gaussians_plain(proj, colors, opac, *geo)
    assert binning.binning_diff(got, plain) == []


SSIM_CASES = {"view": ((1, 3, 96, 128), None), "odd_b2": ((2, 3, 67, 301),
                                                         None),
              "h7": ((1, 3, 7, 300), None), "w6": ((1, 3, 300, 6), None),
              "1x1": ((1, 3, 1, 1), None),
              "nan_inf": ((1, 3, 70, 90), "nonfinite")}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def ssim_pair(shape, kind, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    if kind == "nonfinite":
        flat = a.view(-1)
        idx = torch.randperm(flat.numel(), generator=gen, device=dev)[:9]
        flat[idx[:3]] = float("nan")
        flat[idx[3:6]] = float("inf")
        flat[idx[6:]] = -float("inf")
    return a, b


@pytest.mark.parametrize("case", SSIM_CASES)
def test_ssim_kernels_match_plain(card, case):
    """The blur (at 1, 3, 11 and 31 taps), the map and its VJP (a seeded
    cotangent and a constant one, as `mean` sends) launch once a call and equal
    their plain versions bit for bit; two launches agree."""
    shape, kind = SSIM_CASES[case]
    a, b = ssim_pair(shape, kind, 0, card)
    stack = torch.cat([a, b, a * a, b * b, a * b])
    before = collections.Counter(cuda_lib.LAUNCHES)
    for taps in (1, 3, 11, 31):
        g1d = losses._gaussian_1d(taps, 1.5)
        got = losses.sep_blur(stack, g1d)
        assert same_bits(got, losses.sep_blur(stack, g1d))
        assert same_bits(got, losses._sep_gauss_blur(stack, g1d)), taps
    blurred = got
    fwd = losses.ssim_map_fwd(blurred)
    assert same_bits(fwd, losses.ssim_map_fwd(blurred))
    assert same_bits(fwd, losses._ssim_map_fwd_plain(blurred))
    gen = torch.Generator(device=card).manual_seed(1)
    for ct in (torch.randn(fwd.shape, generator=gen, device=card),
               torch.full(fwd.shape, 0.5, device=card)):
        got = losses.ssim_map_bwd(ct, blurred)
        assert same_bits(got, losses.ssim_map_bwd(ct, blurred))
        assert same_bits(got, losses._ssim_map_bwd_plain(ct, blurred))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES - before == {losses.BLUR_KERNEL: 8,
                                          losses.MAP_FWD_KERNEL: 2,
                                          losses.MAP_BWD_KERNEL: 4}


def value_and_grads(fn, a, b):
    a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = fn(a, b)
    return (out.detach(),
            *torch.autograd.grad(out, (a, b), torch.ones_like(out)))


@pytest.mark.parametrize("case", SSIM_CASES)
def test_ssim_and_masked_ssim_match_plain(card, case, monkeypatch):
    """`ssim` and `masked_ssim` and their gradients through the kernels
    equal the same calls through the plain versions on the card, bit for
    bit."""
    shape, kind = SSIM_CASES[case]
    a, b = ssim_pair(shape, kind, 2, card)
    mask = torch.rand(shape[-2:], generator=torch.Generator(
        device=card).manual_seed(3), device=card) < 0.7
    fns = (losses.ssim, lambda x, y: losses.ssim(x, y, size_average=False),
           lambda x, y: losses.masked_ssim(x, y, mask))
    got = [value_and_grads(fn, a, b) for fn in fns]
    monkeypatch.setattr(losses, "sep_blur", losses._sep_gauss_blur)
    monkeypatch.setattr(losses, "ssim_map_fwd", losses._ssim_map_fwd_plain)
    monkeypatch.setattr(losses, "ssim_map_bwd", losses._ssim_map_bwd_plain)
    before = collections.Counter(cuda_lib.LAUNCHES)
    want = [value_and_grads(fn, a, b) for fn in fns]
    assert cuda_lib.LAUNCHES == before  # the plain path launches nothing
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert same_bits(x, y)


def projection_cases():
    """(name, inputs): chip_smoke.py's crafted cases and a seeded scene of
    20,000 gaussians around the origin seen from 96x64."""
    from chip_smoke import projection_crafted_cases
    cases = list(projection_crafted_cases())
    rng = np.random.default_rng(21)
    n = 20_000
    cam = look_at_camera([0.3, 0.2, -3.0], [0, 0, 0], [0, -1, 0], 1.1, 0.8,
                         96, 64, device="cpu")
    cases.append(("seeded", (
        rng.normal(size=(n, 3)).astype(np.float32),
        np.exp(rng.normal(-3, 1, size=(n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        cam.world_view_transform.numpy(), cam.full_proj_transform.numpy(),
        96, 64, cam.tan_fovx, cam.tan_fovy)))
    return cases


@pytest.mark.parametrize("case", range(3), ids=["crafted", "det0",
                                                "seeded"])
def test_projection_kernels_match_plain(card, case):
    """project_fwd (full and radius only) and project_bwd (the render's
    five cotangents, all six, zeros, none) launch once a call and equal
    their plain versions bit for bit, NaN and inf rows included; two
    launches agree."""
    name, arrays = projection_cases()[case]
    inputs = (*(torch.from_numpy(a).to(card) for a in arrays[:5]),
              *arrays[5:])
    n = arrays[0].shape[0]
    gen = torch.Generator(device=card).manual_seed(case)
    six = [torch.randn(n, generator=gen, device=card) for _ in range(6)]
    before = collections.Counter(cuda_lib.LAUNCHES)
    got = projection.project_fwd(*inputs)
    assert same_bits(got, projection.project_fwd(*inputs))
    assert same_bits(got, projection._project_fwd_plain(*inputs))
    assert same_bits(projection.project_fwd(*inputs, radius_only=True),
                     got[6])
    culled = culled_cotangents((*six[:2], None, *six[3:]), inputs)
    for cots in ((*six[:2], None, *six[3:]), six, (torch.zeros(n,
                                                               device=card),)
                 * 6, (None,) * 6, culled):
        a = projection.project_bwd(cots, *inputs)
        b = projection.project_bwd(cots, *inputs)
        want = projection._project_bwd_plain(cots, *inputs)
        for x, y, z in zip(a, b, want):
            assert same_bits(x, y) and same_bits(x, z)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES - before == {projection.FWD_KERNEL: 4,
                                          projection.BWD_KERNEL: 10}


@pytest.mark.parametrize("offset", PROJ_VIEW_OFFSETS)
@pytest.mark.parametrize("n", PROJ_RAGGED_N)
def test_projection_bwd_ragged_and_misaligned(card, n, offset):
    """project_bwd at ragged sizes (a block of 128 rows and less, at and
    past 128 and 256 rows) on rows that are views 0, 1 and 3 rows into
    larger tensors (bases 12 and 36 B in), with seeded, culled (zero on
    the culled rows), zero and no cotangents: one launch a call, bit for
    bit with `_project_bwd_plain`, two launches alike; the forward too."""
    from chip_smoke import projection_ragged_cases
    cases = dict(projection_ragged_cases(card, 7))
    inputs = cases[f"N {n}, {offset} rows in"]
    assert inputs[0].storage_offset() == 3 * offset
    gen = torch.Generator(device=card).manual_seed(n)
    seeded = tuple(None if k == 2 else torch.randn(n, generator=gen,
                                                   device=card)
                   for k in range(6))
    culled = culled_cotangents(seeded, inputs)
    before = collections.Counter(cuda_lib.LAUNCHES)
    assert same_bits(projection.project_fwd(*inputs),
                     projection._project_fwd_plain(*inputs))
    for cots in (seeded, culled, (torch.zeros(n, device=card),) * 6,
                 (None,) * 6):
        a = projection.project_bwd(cots, *inputs)
        b = projection.project_bwd(cots, *inputs)
        want = projection._project_bwd_plain(cots, *inputs)
        for x, y, z in zip(a, b, want):
            assert same_bits(x, y) and same_bits(x, z)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES - before == {projection.FWD_KERNEL: 1,
                                          projection.BWD_KERNEL: 8}


def test_train_step_projects_in_three_launches_a_view(card, monkeypatch):
    """A training step's projection is the prefilter's and the render's
    forward and one backward a view, and its gradients equal the same
    step's through the plain versions on the card bit for bit."""
    cuda_lib.LAUNCHES.clear()
    got = toy_step(card, False)
    launched = {k: cuda_lib.LAUNCHES[k] for k in projection.KERNELS}
    assert launched == projection_launches(2, 2)
    monkeypatch.setattr(projection, "project_fwd",
                        projection._project_fwd_plain)
    monkeypatch.setattr(projection, "project_bwd",
                        projection._project_bwd_plain)
    before = collections.Counter(cuda_lib.LAUNCHES)
    want = toy_step(card, False)
    assert all(cuda_lib.LAUNCHES[k] == before[k] for k in projection.KERNELS)
    for a, b in zip(leaves(got[:3]), leaves(want[:3])):
        assert torch.equal(a, b)
