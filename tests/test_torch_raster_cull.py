"""The blend backward kernels' per-warp cull, on the CPU.

`cull_rect_plain` (ops/rasterize_cuda.py) is the plain version of the
kernels' `cull_rect` (csrc/raster_bwd_tile.cuh): a warp may skip a record
only if, at every pixel centre of its rectangle, the replay's own float32
arithmetic (as `raster_bwd_plain` computes it) gives power > 0 or alpha <
1/255.  These tests hold that on random and adversarial records, check
that the test does reject what lies far away, and run a plain replay that
skips the culled (record, warp) pairs: its transmittance chain equals the
full replay's bit for bit, and its gradients equal `raster_bwd_plain`'s up
to the order of the pixel sums (1e-6 of each row's max).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from splatco_torch.ops import raster_v3
from splatco_torch.ops.binning import TILE, bin_gaussians
from splatco_torch.ops.projection import ProjectedCols
from splatco_torch.ops.rasterize import tile_grid
from splatco_torch.ops.rasterize_cuda import (ALPHA_MAX, ALPHA_MIN,
                                              BWD_KERNELS, BWD_WARP_RECT,
                                              OP_MIN, T_EPS, _pixel_grid,
                                              _tile, bwd_cull_mask,
                                              cull_rect_plain,
                                              raster_bwd_plain,
                                              raster_fwd_plain)

CSRC = Path(__file__).resolve().parent.parent / "splatco_torch" / "csrc"
GRAD_TOL = 1e-6  # of each row's max |value|: pixel sums in another order


def f32(v):
    return torch.as_tensor(np.asarray(v, np.float32))


def conics(sx, sy, theta):
    """Conic (ca, cb, cc) of the covariance with axes sx, sy at angle
    theta, in float32 as the projection hands them over."""
    c, s = np.cos(theta), np.sin(theta)
    a = c * c * sx * sx + s * s * sy * sy
    b = c * s * (sx * sx - sy * sy)
    d = s * s * sx * sx + c * c * sy * sy
    det = a * d - b * b
    return f32(d / det), f32(-b / det), f32(a / det)


def reaches(mx, my, ca, cb, cc, op, x0, x1, y0, y1):
    """[N] bool: some pixel centre of the rectangle gives power <= 0 and
    alpha >= 1/255 in raster_bwd_plain's float32 arithmetic."""
    px = torch.arange(int(x0), int(x1) + 1, dtype=torch.float32)
    py = torch.arange(int(y0), int(y1) + 1, dtype=torch.float32)
    py, px = torch.meshgrid(py, px, indexing="ij")
    px, py = px.reshape(1, -1), py.reshape(1, -1)
    dx = mx[:, None] - px
    dy = my[:, None] - py
    ca, cb, cc, op = ca[:, None], cb[:, None], cc[:, None], op[:, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
    return ((power <= 0.0) & (alpha >= ALPHA_MIN)).any(dim=1)


def cull(mx, my, ca, cb, cc, op, rect):
    x0, x1, y0, y1 = (torch.full_like(mx, v) for v in rect)
    return cull_rect_plain(mx, my, ca, cb, cc, op, x0, x1, y0, y1)


@settings(max_examples=300, deadline=None, database=None)
@given(rect=st.sampled_from([(16, 8), (8, 8), (8, 4)]),
       corner=st.tuples(st.integers(0, 1600), st.integers(0, 1088)),
       off=st.tuples(st.floats(-1.0, 2.0), st.floats(-1.0, 2.0)),
       spread=st.floats(0.0, 40.0),
       log_s=st.tuples(st.floats(-1.5, 4.0), st.floats(-1.5, 4.0)),
       squash=st.floats(0.0, 7.0), theta=st.floats(0.0, math.pi),
       op=st.floats(1.0 / 255.0 + 1e-6, 0.99))
def test_cull_never_rejects_a_record_that_reaches_the_rectangle(
        rect, corner, off, spread, log_s, squash, theta, op):
    """Centres on and near the rectangle, conics from round to
    near-degenerate (one axis squashed by up to e^7), opacities from just
    above 1/255 to 0.99."""
    rw, rh = rect
    x0, y0 = corner
    box = (x0, x0 + rw - 1, y0, y0 + rh - 1)
    # a centre on the rectangle (off in [0, 1]) or beside it, pushed out by
    # up to `spread` px along the offset's direction
    ox, oy = off
    mx = x0 + ox * (rw - 1) + spread * (ox - 0.5)
    my = y0 + oy * (rh - 1) + spread * (oy - 0.5)
    sx = math.exp(log_s[0])
    sy = max(math.exp(log_s[1] - squash), 1e-3)
    ca, cb, cc = conics(np.array([sx]), np.array([sy]), np.array([theta]))
    args = (f32([mx]), f32([my]), ca, cb, cc, f32([op]))
    if bool(cull(*args, box)[0]):
        assert not bool(reaches(*args, *box)[0])


@pytest.mark.parametrize("rect", [(16, 8), (8, 8), (8, 4)])
def test_cull_is_conservative_and_tight_on_random_records(rect):
    """100k seeded records around an interior rectangle: no record that
    reaches it is rejected, and nearly every one that does not is, as long
    as the conic is not near-degenerate (axes within e^3 of each other;
    beyond that the determinant's margin keeps records)."""
    rng = np.random.default_rng(sum(rect))
    n = 100_000
    rw, rh = rect
    box = (40, 40 + rw - 1, 32, 32 + rh - 1)
    log_sx = rng.uniform(-1.5, 4.0, n)
    log_sy = rng.uniform(-1.5, 4.0, n) - rng.uniform(0.0, 6.0, n)
    ca, cb, cc = conics(np.exp(log_sx), np.exp(log_sy),
                        rng.uniform(0.0, np.pi, n))
    mx = f32(rng.uniform(-40.0, 40.0 + rw + 40.0, n))
    my = f32(rng.uniform(-40.0, 32.0 + rh + 40.0, n))
    op = f32(np.exp(rng.uniform(np.log(1 / 255), np.log(0.99), n)))
    args = (mx, my, ca, cb, cc, op)
    culled = cull(*args, box)
    hit = reaches(*args, *box)
    assert not bool((culled & hit).any())
    assert float(culled.float().mean()) > 0.3
    mild = torch.as_tensor(np.abs(log_sx - log_sy) < 3.0)
    assert float((~culled & ~hit)[mild].float().mean()) < 0.01


def test_cull_rejects_far_and_faint_records_and_keeps_odd_ones():
    ca, cb, cc = conics(np.array([2.0, 2.0, 2.0, 2.0]),
                        np.array([1.0, 1.0, 1.0, 1.0]),
                        np.array([0.3, 0.3, 0.3, 0.3]))
    box = (0, 15, 0, 7)
    # far to the right, far below, on the rectangle with alpha < 1/255,
    # on it and opaque
    mx = f32([200.0, 8.0, 8.0, 8.0])
    my = f32([4.0, -300.0, 4.0, 4.0])
    op = f32([0.9, 0.9, 0.5 / 255.0, 0.9])
    assert cull(mx, my, ca, cb, cc, op, box).tolist() == [True, True,
                                                          True, False]
    # a degenerate or indefinite conic, a NaN opacity: kept
    one = f32([1.0])
    for c3 in ((one, one, one), (one, f32([2.0]), one),
               (f32([-1.0]), f32([0.0]), one)):
        assert not bool(cull(f32([200.0]), f32([4.0]), *c3, f32([0.9]),
                             box)[0])
    assert not bool(cull(f32([200.0]), f32([4.0]), one, f32([0.0]), one,
                         f32([float("nan")]), box)[0])


def test_warp_rects_match_the_kernels_layout():
    """BWD_WARP_RECT is BwdLayout's rectangle at the block size each
    backward source instantiates."""
    for tile, name in BWD_KERNELS.items():
        src = (CSRC / f"{name}.cu").read_text()
        t, block, _ = map(int, re.search(
            r"launch_bwd<(\d+), (\d+), (\d+)>", src).groups())
        assert t == tile
        rows = tile * tile // block
        rw = 16 if rows * 32 >= 128 else 8
        assert BWD_WARP_RECT[tile] == (rw, rows * 32 // rw)


def scene(n, h, w, seed, tile):
    """A seeded projected scene binned at `tile` px: (binned, tiles_x,
    tiles_y)."""
    rng = np.random.default_rng(seed)
    sx, sy = rng.uniform(0.5, 8.0, n), rng.uniform(0.5, 8.0, n)
    ca, cb, cc = conics(sx, sy, rng.uniform(0.0, np.pi, n))
    radius = f32(np.ceil(3.0 * np.maximum(sx, sy)))
    proj = ProjectedCols(mx=f32(rng.uniform(-10, w + 10, n)),
                         my=f32(rng.uniform(-10, h + 10, n)),
                         depth=f32(rng.uniform(1, 5, n)), ca=ca, cb=cb,
                         cc=cc, radius=radius)
    colors = f32(rng.uniform(0.0, 1.0, (n, 3)))
    opac = f32(rng.uniform(0.05, 0.99, n))
    if tile == raster_v3.TILE:
        tiles_x, tiles_y = raster_v3.tile_grid(h, w)
        return (raster_v3.bin_gaussians_v3(proj, colors, opac, tiles_x,
                                           tiles_y, kmax=32),
                tiles_x, tiles_y)
    tiles_x, tiles_y = tile_grid(h, w)
    return (bin_gaussians(proj, colors, opac, TILE, tiles_x, tiles_y,
                          kmax=16), tiles_x, tiles_y)


def culled_replay(records, tile_start, tile_end, tiles_x, tiles_y, height,
                  width, grad, rgb, t_final, bg, tile):
    """raster_bwd_plain with each warp skipping the records that
    bwd_cull_mask rejects for its rectangle.  Asserts at every step that
    the transmittance and liveness equal the full replay's; returns the
    per-record gradients [9, P] and the share of pairs skipped."""
    skip = bwd_cull_mask(records, tile_start, tile_end, tiles_x, tiles_y,
                         tile)                                # [P, W]
    rw, rh = BWD_WARP_RECT[tile]
    p_idx = torch.arange(tile * tile)
    warp_of = (p_idx // tile // rh) * (tile // rw) + (p_idx % tile) // rw
    num_tiles = tiles_x * tiles_y
    px, py, live = _pixel_grid(tiles_x, tiles_y, height, width,
                               records.device, tile)
    full_live = live.clone()
    g = _tile(grad, tiles_x, tiles_y, tile)
    acc = _tile(rgb, tiles_x, tiles_y, tile)
    t_fin = _tile(t_final[None], tiles_x, tiles_y, tile)[0]
    gtot = ((acc[0] * g[0] + acc[1] * g[1] + acc[2] * g[2])
            + (bg[0] * g[0] + bg[1] * g[1] + bg[2] * g[2]) * t_fin)
    trans = torch.ones((num_tiles, tile * tile))
    full_trans = trans.clone()
    prefix = torch.zeros((num_tiles, tile * tile))
    out = torch.zeros_like(records)
    start = tile_start.to(torch.int64)
    count = (tile_end - tile_start).to(torch.int64)
    for step in range(int(count.max()) if num_tiles else 0):
        has = count > step
        rows = torch.where(has, start + step, 0)
        rec = records[:, rows][:, :, None]
        mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        one_m = 1.0 - alpha
        test_t = trans * one_m
        # the full replay's chain, every pixel evaluated
        full_ok = full_live & has[:, None] & (power <= 0.0) & (
            alpha >= ALPHA_MIN)
        full_stop = full_ok & (full_trans * one_m < T_EPS)
        full_trans = torch.where(full_ok & ~full_stop, full_trans * one_m,
                                 full_trans)
        full_live = full_live & ~full_stop
        # the culled one: a pixel of a warp that skips the record does not
        # evaluate it
        kept = ~skip[rows][:, warp_of]                       # [T, tile^2]
        ok = live & has[:, None] & kept & (power <= 0.0) & (
            alpha >= ALPHA_MIN)
        stop = ok & (test_t < T_EPS)
        contrib = ok & ~stop
        w = torch.where(contrib, alpha * trans, 0.0)
        gc = rec[6] * g[0] + rec[7] * g[1] + rec[8] * g[2]
        prefix = torch.where(contrib, prefix + gc * w, prefix)
        d_alpha = torch.where(
            contrib, gc * trans - (gtot - prefix)
            / torch.clamp_min(one_m, 1.0 - ALPHA_MAX), 0.0)
        d_power = torch.where(alpha < ALPHA_MAX, d_alpha * alpha, 0.0)
        dpx = d_power * dx
        dpy = d_power * dy
        # per warp first, then the warps in order, as the kernel sums
        terms = torch.stack([d_power, dpx, dpy, dpx * dx, dpx * dy, dpy * dy,
                             g[0] * w, g[1] * w, g[2] * w])
        s = terms.reshape(9, num_tiles, tile // rh, rh, tile // rw,
                          rw).sum(dim=(3, 5)).reshape(9, num_tiles, -1)
        s = s.sum(dim=-1)
        ca, cb, cc, op = ca[:, 0], cb[:, 0], cc[:, 0], op[:, 0]
        grads = torch.stack([-(ca * s[1] + cb * s[2]),
                             -(cb * s[1] + cc * s[2]),
                             -0.5 * s[3], -s[4], -0.5 * s[5],
                             s[0] / torch.clamp_min(op, OP_MIN),
                             s[6], s[7], s[8]])
        out[:, rows[has]] = grads[:, has]
        trans = torch.where(contrib, test_t, trans)
        live = live & ~stop
        assert torch.equal(trans, full_trans)
        assert torch.equal(live, full_live)
    return out, float(skip.float().mean())


@pytest.mark.parametrize("tile", [TILE, raster_v3.TILE])
def test_culled_replay_matches_raster_bwd_plain(tile):
    h, w = 72, 100
    binned, tiles_x, tiles_y = scene(700, h, w, 5, tile)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, h, w)
    rgb, t_fin = raster_fwd_plain(*args, tile=tile)
    grad = torch.zeros_like(rgb)
    grad[:, :h, :w] = f32(np.random.default_rng(6).normal(size=(3, h, w)))
    bg = f32([0.2, 0.3, 0.4])
    want = raster_bwd_plain(*args, grad, rgb, t_fin, bg, tile=tile)
    got, skipped = culled_replay(*args, grad, rgb, t_fin, bg, tile)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert bool(scale.min() > 0)
    assert bool(((got - want).abs() <= GRAD_TOL * scale).all())
    # the scene exercises both the cull and termination
    assert skipped > 0.2
    assert float((t_fin[:h, :w] < 1e-3).float().mean()) > 0.05
