"""splatco_torch's CUDA kernels on the card (marker `gpu`; skipped where
there is no card), in both rasterizer configurations (32 px tiles, v2;
16 px tiles, v3).  These need no JAX, so they run on a machine without
it:  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The blend kernels are built with --fmad=false and repeat their plain
versions' float32 operations in the same order, so the forwards agree to
the CPU tests' bound of 1e-5 (in practice bit for bit, up to the library
exp).  The backward's per-record sums over a tile's 1024 pixels are taken
in another order than the plain version's, so each of its nine rows is
held to 1e-5 of that row's largest |value|.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.splatco import init_model
from splatco_torch.ops import cuda_lib, raster_v3
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import tile_grid
from splatco_torch.ops.rasterize_cuda import (BWD_KERNELS, FWD_KERNELS,
                                              raster_bwd, raster_bwd_plain,
                                              raster_fwd, raster_fwd_plain)
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import init_stats, make_train_step

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
    assert float((rgb - p_rgb).abs().max()) <= 1e-5
    assert float((t_fin - p_t).abs().max()) <= 1e-5
    again, _ = raster_fwd(*args, tile=tile)
    assert torch.equal(rgb, again)  # no atomics: run to run identical


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


def toy_step(dev, tile16=None):
    """One SVC step (q = 0) of a small seeded model on `dev`."""
    cfg = ModelConfig(feat_dim=16, n_offsets=4, voxel_size=0.05,
                      plane_size=64, num_channels=9, appearance_dim=0,
                      contractor=True, scene_center=[0.0, 0.0, 0.0],
                      scene_length=[2.0, 2.0, 2.0])
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
