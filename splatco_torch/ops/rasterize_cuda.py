"""Tile alpha-blend forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions (counterparts of `_fwd_kernel` /
`forward_pallas` and `_bwd_kernel` / `backward_pallas` in
splatco_tpu/ops/rasterize_pallas.py), for a pixel tile of 32 px (the v2
configuration, the default) or 16 px (the v3 configuration: see
ops/raster_v3.py).

`raster_fwd` takes the binned records (SoA [9, P] float32: mx, my, ca, cb,
cc, op, r, g, b; per-tile [start, end) int32, tiles row-major) and returns
rgb [3, Hp, Wp] (no background) and the final transmittance [Hp, Wp] in
image layout, Hp = tile * tiles_y, Wp = tile * tiles_x.
`raster_bwd` takes the same records, the image's cotangent [3, Hp, Wp]
(zero outside H x W), the forward's rgb and T_final and the background
[3], and returns the per-record gradients [9, P] in record order.
For CUDA tensors each launches its kernel for the tile size
(`csrc/raster_fwd.cu`, `csrc/raster_bwd.cu` at 32 px;
`csrc/raster_fwd16.cu`, `csrc/raster_bwd16.cu` at 16 px); for CPU tensors
it runs its plain version.  There is no fallback from one to the other.

The plain versions are vectorised over tiles and pixels and serial over
each tile's records, so they round exactly as the kernels' per-pixel
loops do: on the same inputs the forwards agree bit for bit (both use
CUDA's `expf` on the card); the backwards differ only in the order of the
sums over a tile's pixels (and the kernels fuse the multiply-adds of
those sums).  Every kernel skips, per warp, the records `cull_rect_plain`
rejects for the warp's pixel rectangle (FWD_WARP_RECT, BWD_WARP_RECT): an
exact skip, so it changes no result.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from splatco_torch.ops import cuda_lib
from splatco_torch.ops.binning import NUM_REC, TILE

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
OP_MIN = 1e-12
KERNEL = "raster_fwd"
BWD_KERNEL = "raster_bwd"
# kernel (and C entry point) of each pixel tile size
FWD_KERNELS = {TILE: KERNEL, 16: "raster_fwd16"}
BWD_KERNELS = {TILE: BWD_KERNEL, 16: "raster_bwd16"}
# the pixel rectangle (width, height) each warp of a blend kernel owns:
# WarpLayout in csrc/raster_tile.cuh at the block size the kernel's source
# instantiates (forward: 512 threads at 32 px, 128 at 16 px; backward: 256
# and 64)
FWD_WARP_RECT = {TILE: (8, 8), 16: (8, 8)}
BWD_WARP_RECT = {TILE: (16, 8), 16: (16, 8)}


def _check_inputs(records, tile_start, tile_end, tiles_x, tiles_y):
    if records.dtype != torch.float32 or records.dim() != 2 \
            or records.shape[0] != NUM_REC or not records.is_contiguous():
        raise ValueError("records must be contiguous float32 [9, P], got "
                         f"{records.dtype} {tuple(records.shape)}")
    for name, t in (("tile_start", tile_start), ("tile_end", tile_end)):
        if t.dtype != torch.int32 or t.shape != (tiles_x * tiles_y,) \
                or not t.is_contiguous() or t.device != records.device:
            raise ValueError(f"{name} must be contiguous int32 "
                             f"[{tiles_x * tiles_y}] on {records.device}")


def _pixel_grid(tiles_x: int, tiles_y: int, height: int, width: int,
                dev: torch.device, tile: int):
    """Pixel centres (px, py) [T, tile^2] float32 of every tile, row-major
    within the tile, and the in-image mask."""
    t_idx = torch.arange(tiles_x * tiles_y, device=dev)
    p_idx = torch.arange(tile * tile, device=dev)
    x = (t_idx % tiles_x)[:, None] * tile + (p_idx % tile)[None, :]
    y = (t_idx // tiles_x)[:, None] * tile + (p_idx // tile)[None, :]
    return x.to(torch.float32), y.to(torch.float32), (x < width) & (
        y < height)


def _untile(v: torch.Tensor, tiles_x: int, tiles_y: int,
            tile: int) -> torch.Tensor:
    """[C, T, tile^2] tile layout -> [C, Hp, Wp] image layout."""
    c = v.shape[0]
    return (v.reshape(c, tiles_y, tiles_x, tile, tile)
            .permute(0, 1, 3, 2, 4)
            .reshape(c, tiles_y * tile, tiles_x * tile))


def _tile(v: torch.Tensor, tiles_x: int, tiles_y: int,
          tile: int) -> torch.Tensor:
    """[C, Hp, Wp] image layout -> [C, T, tile^2] tile layout."""
    c = v.shape[0]
    return (v.reshape(c, tiles_y, tile, tiles_x, tile)
            .permute(0, 1, 3, 2, 4)
            .reshape(c, tiles_y * tiles_x, tile * tile))


def raster_fwd_plain(records: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                     height: int, width: int,
                     work: Optional[Dict[str, torch.Tensor]] = None,
                     tile: int = TILE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blend in plain PyTorch: step l processes the l-th record of
    every tile for all of its pixels at once.  With `work` given, it also
    counts the pixel evaluations up to termination ("evals") and the
    contributions ("contribs") this input needs."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    px, py, live = _pixel_grid(tiles_x, tiles_y, height, width, dev, tile)
    trans = torch.ones((num_tiles, tile * tile), device=dev)
    acc = torch.zeros((3, num_tiles, tile * tile), device=dev)
    start = tile_start.to(torch.int64)
    count = (tile_end - tile_start).to(torch.int64)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(count.max()) if num_tiles else 0
    for step in range(steps):
        has = count > step
        rec = records[:, torch.where(has, start + step, 0)][:, :, None]
        mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        todo = live & has[:, None]
        ok = todo & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        contrib = ok & ~stop
        w = torch.where(contrib, alpha * trans, 0.0)
        acc = acc + rec[6:9] * w[None]
        trans = torch.where(contrib, test_t, trans)
        live = live & ~stop
        if work is not None:
            evals += todo.sum()
            contribs += contrib.sum()
    if work is not None:
        work["evals"] = evals
        work["contribs"] = contribs

    return (_untile(acc, tiles_x, tiles_y, tile),
            _untile(trans[None], tiles_x, tiles_y, tile)[0])


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(cuda_lib.load(name), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def raster_fwd(records: torch.Tensor, tile_start: torch.Tensor,
               tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
               height: int, width: int, tile: int = TILE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend the binned records: (rgb [3, Hp, Wp], t_final [Hp, Wp])."""
    name = FWD_KERNELS[tile]
    _check_inputs(records, tile_start, tile_end, tiles_x, tiles_y)
    if records.device.type == "cpu":
        return raster_fwd_plain(records, tile_start, tile_end, tiles_x,
                                tiles_y, height, width, tile=tile)
    if records.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {records.device}")
    hp, wp = tiles_y * tile, tiles_x * tile
    rgb = torch.empty((3, hp, wp), dtype=torch.float32,
                      device=records.device)
    t_final = torch.empty((hp, wp), dtype=torch.float32,
                          device=records.device)
    fn = _kernel(name)
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = fn(records.data_ptr(), records.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), tiles_x,
                 tiles_y, height, width, rgb.data_ptr(), t_final.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_lib.LAUNCHES[name] += 1
    return rgb, t_final


def _check_bwd_inputs(records, tiles_x, tiles_y, grad, rgb, t_final, bg,
                      tile):
    hp, wp = tiles_y * tile, tiles_x * tile
    for name, t, shape in (("grad", grad, (3, hp, wp)),
                           ("rgb", rgb, (3, hp, wp)),
                           ("t_final", t_final, (hp, wp)),
                           ("bg", bg, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != records.device:
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{records.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def raster_bwd_plain(records: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                     height: int, width: int, grad: torch.Tensor,
                     rgb: torch.Tensor, t_final: torch.Tensor,
                     bg: torch.Tensor,
                     work: Optional[Dict[str, torch.Tensor]] = None,
                     tile: int = TILE
                     ) -> torch.Tensor:
    """The blend's gradient in plain PyTorch: step l replays the l-th
    record of every tile for all of its pixels at once (the forward's
    arithmetic), forms dL/dpower and reduces the nine per-record sums over
    the tile's pixels.  Returns the per-record gradients [9, P].  With
    `work` given, it also counts the pixel evaluations up to termination
    ("evals") and the contributions ("contribs")."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    px, py, live = _pixel_grid(tiles_x, tiles_y, height, width, dev, tile)
    g = _tile(grad, tiles_x, tiles_y, tile)                # [3, T, tile^2]
    acc = _tile(rgb, tiles_x, tiles_y, tile)
    t_fin = _tile(t_final[None], tiles_x, tiles_y, tile)[0]
    gtot = ((acc[0] * g[0] + acc[1] * g[1] + acc[2] * g[2])
            + (bg[0] * g[0] + bg[1] * g[1] + bg[2] * g[2]) * t_fin)
    trans = torch.ones((num_tiles, tile * tile), device=dev)
    prefix = torch.zeros((num_tiles, tile * tile), device=dev)
    out = torch.zeros_like(records)
    start = tile_start.to(torch.int64)
    count = (tile_end - tile_start).to(torch.int64)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(count.max()) if num_tiles else 0
    for step in range(steps):
        has = count > step
        rows = torch.where(has, start + step, 0)
        rec = records[:, rows][:, :, None]
        mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        todo = live & has[:, None]
        ok = todo & (power <= 0.0) & (alpha >= ALPHA_MIN)
        one_m = 1.0 - alpha
        test_t = trans * one_m
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
        s = torch.stack([d_power, dpx, dpy, dpx * dx, dpx * dy, dpy * dy,
                         g[0] * w, g[1] * w, g[2] * w]).sum(dim=-1)
        ca, cb, cc, op = ca[:, 0], cb[:, 0], cc[:, 0], op[:, 0]
        grads = torch.stack([-(ca * s[1] + cb * s[2]),
                             -(cb * s[1] + cc * s[2]),
                             -0.5 * s[3], -s[4], -0.5 * s[5],
                             s[0] / torch.clamp_min(op, OP_MIN),
                             s[6], s[7], s[8]])             # [9, T]
        out[:, rows[has]] = grads[:, has]
        trans = torch.where(contrib, test_t, trans)
        live = live & ~stop
        if work is not None:
            evals += todo.sum()
            contribs += contrib.sum()
    if work is not None:
        work["evals"] = evals
        work["contribs"] = contribs
    return out


def cull_rect_plain(mx, my, ca, cb, cc, op, x0, x1, y0, y1
                    ) -> torch.Tensor:
    """The blend kernels' per-warp cull (`cull_rect` in
    csrc/raster_tile.cuh) in float32, elementwise over broadcast tensors:
    True where the record (mx, my, ca, cb, cc, op) gives power > 0 or
    alpha < 1/255 at every pixel centre of [x0, x1] x [y0, y1] under the
    blend's own float32 arithmetic (the forward's, which the backward
    replays), so skipping it there is exact.  A lower bound of the conic
    form, shrunk to cover that arithmetic's rounding, over the rectangle
    (0 if the mean lies inside, else the least of the four edges'
    one-dimensional minima) against 2 log(255 op), with
    margins for this test's own rounding."""
    lim = torch.log(op * 255.0)
    lim = lim + 1e-4 + 1e-6 * lim.abs()
    a = ca * (1.0 - 2e-5)
    c = cc * (1.0 - 2e-5)
    b = cb
    ac, bb = a * c, b * b
    det = (ac - bb) - 1e-6 * (ac + bb)
    ex = 1e-6 * (mx.abs() + x0.abs() + x1.abs())
    ey = 1e-6 * (my.abs() + y0.abs() + y1.abs())
    dx0, dx1 = (mx - x1) - ex, (mx - x0) + ex
    dy0, dy1 = (my - y1) - ey, (my - y0) + ey
    inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)

    def dist_lb(s, lo, hi):
        d = torch.maximum(lo - s, s - hi)
        return torch.clamp_min(d - 1e-6 * (s.abs() + lo.abs() + hi.abs()),
                               0.0)

    def edge_x(e):
        t = dist_lb(-b * e / c, dy0, dy1)
        return det * e * e / c + c * t * t

    def edge_y(e):
        t = dist_lb(-b * e / a, dx0, dx1)
        return det * e * e / a + a * t * t

    lb = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                       torch.minimum(edge_y(dy0), edge_y(dy1)))
    lb = torch.where(inside, 0.0, lb)
    return (a > 0.0) & (c > 0.0) & (det > 0.0) & (
        lb * (0.5 * (1.0 - 1e-5)) > lim)


def warp_cull_mask(records: torch.Tensor, tile_start: torch.Tensor,
                   tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                   tile: int, rect: Tuple[int, int]) -> torch.Tensor:
    """[P, W] bool: True where `cull_rect_plain` lets warp w skip record p,
    against the (width, height) `rect` warp w owns in p's tile (the warps
    row-major over the tile)."""
    dev = records.device
    rw, rh = rect
    t_idx = torch.arange(tiles_x * tiles_y, device=dev)
    w_idx = torch.arange(tile * tile // (rw * rh), device=dev)
    per_row = tile // rw                                # warps a tile row
    x0 = (t_idx % tiles_x)[:, None] * tile + (w_idx % per_row)[None] * rw
    y0 = (t_idx // tiles_x)[:, None] * tile + (w_idx // per_row)[None] * rh
    rects = torch.stack([x0, x0 + rw - 1, y0, y0 + rh - 1], dim=-1).to(
        torch.float32)                                  # [T, W, 4]
    count = (tile_end - tile_start).to(torch.int64)
    of_rec = torch.repeat_interleave(torch.arange(count.numel(), device=dev),
                                     count)             # tile of each read
    first = torch.cumsum(count, 0) - count
    pos = (tile_start.to(torch.int64)[of_rec]
           + torch.arange(of_rec.numel(), device=dev) - first[of_rec])
    rects = rects[of_rec]
    r = records[:6, pos][:, :, None]
    mask = torch.zeros((records.shape[1], rects.shape[1]), dtype=torch.bool,
                       device=dev)
    mask[pos] = cull_rect_plain(r[0], r[1], r[2], r[3], r[4], r[5],
                                rects[..., 0], rects[..., 1], rects[..., 2],
                                rects[..., 3])
    return mask


def fwd_cull_mask(records: torch.Tensor, tile_start: torch.Tensor,
                  tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                  tile: int = TILE) -> torch.Tensor:
    """[P, W] bool: the (record, warp) pairs the forward kernel skips
    (`warp_cull_mask` on FWD_WARP_RECT)."""
    return warp_cull_mask(records, tile_start, tile_end, tiles_x, tiles_y,
                          tile, FWD_WARP_RECT[tile])


def bwd_cull_mask(records: torch.Tensor, tile_start: torch.Tensor,
                  tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                  tile: int = TILE) -> torch.Tensor:
    """[P, W] bool: the (record, warp) pairs the backward kernel skips
    (`warp_cull_mask` on BWD_WARP_RECT)."""
    return warp_cull_mask(records, tile_start, tile_end, tiles_x, tiles_y,
                          tile, BWD_WARP_RECT[tile])


@functools.lru_cache(maxsize=None)
def _bwd_kernel(name: str):
    fn = getattr(cuda_lib.load(name), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, p, p, p, p, p, p]
    fn.restype = i
    return fn


def raster_bwd(records: torch.Tensor, tile_start: torch.Tensor,
               tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
               height: int, width: int, grad: torch.Tensor,
               rgb: torch.Tensor, t_final: torch.Tensor, bg: torch.Tensor,
               tile: int = TILE) -> torch.Tensor:
    """Per-record gradients [9, P] of the blend (rows mx, my, ca, cb, cc,
    op, r, g, b) for the image cotangent `grad` [3, Hp, Wp]."""
    name = BWD_KERNELS[tile]
    _check_inputs(records, tile_start, tile_end, tiles_x, tiles_y)
    _check_bwd_inputs(records, tiles_x, tiles_y, grad, rgb, t_final, bg,
                      tile)
    if records.device.type == "cpu":
        return raster_bwd_plain(records, tile_start, tile_end, tiles_x,
                                tiles_y, height, width, grad, rgb, t_final,
                                bg, tile=tile)
    if records.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {records.device}")
    out = torch.zeros_like(records)
    fn = _bwd_kernel(name)
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = fn(records.data_ptr(), records.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), tiles_x,
                 tiles_y, height, width, grad.data_ptr(), rgb.data_ptr(),
                 t_final.data_ptr(), bg.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_lib.LAUNCHES[name] += 1
    return out
