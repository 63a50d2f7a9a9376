"""The blend forward kernels' per-warp cull and layout, on the CPU.

Each warp of `raster_fwd` / `raster_fwd16` (csrc/raster_tile.cuh) owns a
pixel rectangle (FWD_WARP_RECT) and walks only the records that
`cull_rect` does not reject for it.  A plain forward replay that skips the
same (record, warp) pairs (`fwd_cull_mask`) must equal `raster_fwd_plain`
bit for bit in rgb and T: the kernels are held to the plain version
exactly, so the skip has to be exact.  Scenes: random, a tile deeper than
three of the kernel's record batches, an opaque region that ends some
warps of a tile early while others stay live, and image edges that cut
warp rectangles; both tile sizes.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from splatco_torch.ops import raster_v3
from splatco_torch.ops.binning import TILE
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import bin_frame
from splatco_torch.ops.rasterize_cuda import (ALPHA_MAX, ALPHA_MIN,
                                              FWD_KERNELS, FWD_WARP_RECT,
                                              T_EPS, _pixel_grid, _untile,
                                              fwd_cull_mask,
                                              raster_fwd_plain)

CSRC = Path(__file__).resolve().parent.parent / "splatco_torch" / "csrc"
BATCH = 128  # kFwdBatch in csrc/raster_tile.cuh: records staged at once


def f32(v):
    return torch.as_tensor(np.asarray(v, np.float32))


def crafted_scene(kind, h, w, tile):
    """Projected gaussians (proj, colors, opac) made by numpy from a seed:
      random: 700 gaussians of 0.5-8 px over the image;
      deep:   700 faint gaussians around one spot, so a tile holds more
              than three batches and pixels away from the spot stay live;
      opaque: 1200 faint gaussians over the image behind 300 opaque ones
              in its top left corner, so the pixels there terminate in the
              first batch: every pixel of the corner warps, some of their
              neighbours', none further out;
      edge:   as random, on an image whose size cuts warp rectangles."""
    rng = np.random.default_rng({"random": 1, "deep": 2, "opaque": 3,
                                 "edge": 4}[kind] + tile)
    n = {"random": 700, "deep": 700, "opaque": 1500, "edge": 700}[kind]
    sx, sy = rng.uniform(0.5, 8.0, n), rng.uniform(0.5, 8.0, n)
    mx, my = rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)
    op = rng.uniform(0.05, 0.99, n)
    depth = rng.uniform(1, 5, n)
    if kind == "deep":
        sx, sy = rng.uniform(1.0, 4.0, n), rng.uniform(1.0, 4.0, n)
        mx, my = rng.uniform(20, 28, n), rng.uniform(20, 28, n)
        op = rng.uniform(0.01, 0.03, n)
    if kind == "opaque":
        front = np.arange(n) < 300
        sx = np.where(front, rng.uniform(3.5, 4.5, n),
                      rng.uniform(1.0, 3.0, n))
        sy = np.where(front, rng.uniform(3.5, 4.5, n), sy)
        mx = np.where(front, rng.uniform(-2, 14, n), mx)
        my = np.where(front, rng.uniform(-2, 6, n), my)
        op = np.where(front, 0.99, rng.uniform(0.02, 0.1, n))
        depth = np.where(front, 0.5, depth)
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    sxx = c * c * sx * sx + s * s * sy * sy + 0.3
    sxy = c * s * (sx * sx - sy * sy)
    syy = s * s * sx * sx + c * c * sy * sy + 0.3
    det = sxx * syy - sxy * sxy
    proj = ProjectedCols(mx=f32(mx), my=f32(my), depth=f32(depth),
                         ca=f32(syy / det), cb=f32(-sxy / det),
                         cc=f32(sxx / det),
                         radius=f32(np.ceil(3.0 * np.sqrt(np.maximum(sxx,
                                                                     syy)))))
    return proj, f32(rng.uniform(0, 1, (n, 3))), f32(op)


def culled_fwd_replay(records, tile_start, tile_end, tiles_x, tiles_y,
                      height, width, tile):
    """raster_fwd_plain with each warp skipping the records that
    fwd_cull_mask rejects for its rectangle, in the kernels' form (a pixel
    adds only where a record contributes).  Returns rgb, T_final, the
    final live mask [T, tile^2] and the share of pairs skipped."""
    skip = fwd_cull_mask(records, tile_start, tile_end, tiles_x, tiles_y,
                         tile)                                 # [P, W]
    rw, rh = FWD_WARP_RECT[tile]
    p_idx = torch.arange(tile * tile)
    warp_of = (p_idx // tile // rh) * (tile // rw) + (p_idx % tile) // rw
    px, py, live = _pixel_grid(tiles_x, tiles_y, height, width,
                               records.device, tile)
    trans = torch.ones((tiles_x * tiles_y, tile * tile))
    acc = torch.zeros((3, tiles_x * tiles_y, tile * tile))
    start = tile_start.to(torch.int64)
    count = (tile_end - tile_start).to(torch.int64)
    for step in range(int(count.max()) if count.numel() else 0):
        has = count > step
        rows = torch.where(has, start + step, 0)
        rec = records[:, rows][:, :, None]
        mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        kept = ~skip[rows][:, warp_of]                          # [T, tile^2]
        ok = live & has[:, None] & kept & (power <= 0.0) & (
            alpha >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        contrib = ok & ~stop
        acc = torch.where(contrib, acc + rec[6:9] * (alpha * trans), acc)
        trans = torch.where(contrib, test_t, trans)
        live = live & ~stop
    return (_untile(acc, tiles_x, tiles_y, tile),
            _untile(trans[None], tiles_x, tiles_y, tile)[0], live,
            float(skip.float().mean()))


@pytest.mark.parametrize("kind,h,w", [("random", 72, 100), ("deep", 64, 64),
                                      ("opaque", 64, 96), ("edge", 37, 70)])
@pytest.mark.parametrize("tile", [TILE, raster_v3.TILE])
def test_culled_fwd_replay_matches_raster_fwd_plain(kind, h, w, tile):
    proj, colors, opac = crafted_scene(kind, h, w, tile)
    binned, tiles_x, tiles_y = bin_frame(proj, colors, opac, tile, h, w, 64)
    assert int(binned.num_clipped) == 0
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    want_rgb, want_t = raster_fwd_plain(*args, tile=tile)
    rgb, t_fin, live, skipped = culled_fwd_replay(*args, tile)
    assert torch.equal(rgb, want_rgb) and torch.equal(t_fin, want_t)
    # the scene exercises what it is named for
    count = binned.tile_end - binned.tile_start
    rw, rh = FWD_WARP_RECT[tile]
    assert skipped > 0.05
    if kind == "deep":
        assert int(count.max()) > 3 * BATCH
    if kind == "opaque":
        # a tile deeper than a batch where a warp's in-image pixels all
        # terminated while another warp's run on to the end
        _, _, inside = _pixel_grid(tiles_x, tiles_y, h, w, torch.device(
            "cpu"), tile)
        by_warp = (tile // rh, rh, tile // rw, rw)
        done = (~live | ~inside).reshape(-1, *by_warp).all(dim=(2, 4))
        ended = (~live & inside).reshape(-1, *by_warp).any(dim=(2, 4))
        running = live.reshape(-1, *by_warp).any(dim=(2, 4))
        mixed = (done & ended).flatten(1).any(1) & running.flatten(1).any(1)
        assert bool((mixed & (count > BATCH)).any())
    if kind == "edge":
        assert h % rh and w % rw and h % tile and w % tile


def test_fwd_warp_rects_match_the_kernels_layout():
    """FWD_WARP_RECT is WarpLayout's rectangle at the block size every
    forward source instantiates (the ablation's too), and the sources of
    one tile size agree on block size and register cap."""
    seen = {}
    for src in sorted(CSRC.glob("raster_fwd*.cu")):
        for t, block, minb in re.findall(
                r"launch_fwd<(\d+), (\d+), (\d+)", src.read_text()):
            seen.setdefault(int(t), set()).add((int(block), int(minb)))
    assert set(seen) == set(FWD_KERNELS) == set(FWD_WARP_RECT)
    for tile, shapes in seen.items():
        assert len(shapes) == 1, shapes
        (block, _), = shapes
        rows = tile * tile // block
        rw = 16 if rows * 32 >= 128 else 8
        assert FWD_WARP_RECT[tile] == (rw, rows * 32 // rw)
