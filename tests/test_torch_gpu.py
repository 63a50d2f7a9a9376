"""splatco_torch's CUDA kernels on the card (marker `gpu`; skipped where
there is no card).  These need no JAX, so they run on a machine without
it:  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The blend kernel is built with --fmad=false and repeats its plain
version's float32 operations in the same order, so the two agree to the
CPU tests' bound of 1e-5 (in practice bit for bit, up to the library exp).
"""
import math

import pytest
import torch

from splatco_torch.ops import cuda_lib
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import tile_grid
from splatco_torch.ops.rasterize_cuda import (KERNEL, raster_fwd,
                                              raster_fwd_plain)

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("n,h,w", [(3000, 200, 300), (0, 64, 64),
                                   (500, 37, 70)])
def test_raster_fwd_kernel_matches_plain(card, n, h, w):
    proj, colors, opac = scene(n, h, w, n + h, card)
    tiles_x, tiles_y = tile_grid(h, w)
    binned = bin_gaussians(proj, colors, opac, TILE, tiles_x, tiles_y)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    before = cuda_lib.LAUNCHES[KERNEL]
    rgb, t_fin = raster_fwd(*args)
    assert cuda_lib.LAUNCHES[KERNEL] == before + 1
    p_rgb, p_t = raster_fwd_plain(*args)
    torch.cuda.synchronize()
    assert float((rgb - p_rgb).abs().max()) <= 1e-5
    assert float((t_fin - p_t).abs().max()) <= 1e-5
    again, _ = raster_fwd(*args)
    assert torch.equal(rgb, again)  # no atomics: run to run identical
