"""Tile alpha-blend forward: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of `_fwd_kernel` / `forward_pallas` in
splatco_tpu/ops/rasterize_pallas.py).

`raster_fwd` takes the binned records (SoA [9, P] float32: mx, my, ca, cb,
cc, op, r, g, b; per-tile [start, end) int32) and returns rgb [3, Hp, Wp]
(no background) and the final transmittance [Hp, Wp] in image layout.
For CUDA tensors it launches `csrc/raster_fwd.cu`; for CPU tensors it
runs `raster_fwd_plain`.  There is no fallback from one to the other.

The plain version is vectorised over tiles and pixels and serial over
each tile's records, so it rounds exactly as the kernel's per-pixel loop
does: on the same inputs the two agree bit for bit, up to the library
`exp` (both use CUDA's `expf` on the card).
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
KERNEL = "raster_fwd"


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


def raster_fwd_plain(records: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                     height: int, width: int,
                     work: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blend in plain PyTorch: step l processes the l-th record of
    every tile for all of its pixels at once.  With `work` given, it also
    counts the pixel evaluations up to termination ("evals") and the
    contributions ("contribs") this input needs."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    t_idx = torch.arange(num_tiles, device=dev)
    p_idx = torch.arange(TILE * TILE, device=dev)
    x = (t_idx % tiles_x)[:, None] * TILE + (p_idx % TILE)[None, :]
    y = (t_idx // tiles_x)[:, None] * TILE + (p_idx // TILE)[None, :]
    px, py = x.to(torch.float32), y.to(torch.float32)
    live = (x < width) & (y < height)                     # [T, 1024]
    trans = torch.ones((num_tiles, TILE * TILE), device=dev)
    acc = torch.zeros((3, num_tiles, TILE * TILE), device=dev)
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

    def image(v):  # [C, T, 1024] -> [C, Hp, Wp]
        c = v.shape[0]
        return (v.reshape(c, tiles_y, tiles_x, TILE, TILE)
                .permute(0, 1, 3, 2, 4)
                .reshape(c, tiles_y * TILE, tiles_x * TILE))

    return image(acc), image(trans[None])[0]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_lib.load(KERNEL).raster_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def raster_fwd(records: torch.Tensor, tile_start: torch.Tensor,
               tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
               height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend the binned records: (rgb [3, Hp, Wp], t_final [Hp, Wp])."""
    _check_inputs(records, tile_start, tile_end, tiles_x, tiles_y)
    if records.device.type == "cpu":
        return raster_fwd_plain(records, tile_start, tile_end, tiles_x,
                                tiles_y, height, width)
    if records.device.type != "cuda":
        raise ValueError(f"raster_fwd: unsupported device {records.device}")
    hp, wp = tiles_y * TILE, tiles_x * TILE
    rgb = torch.empty((3, hp, wp), dtype=torch.float32,
                      device=records.device)
    t_final = torch.empty((hp, wp), dtype=torch.float32,
                          device=records.device)
    fn = _kernel()
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = fn(records.data_ptr(), records.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), tiles_x,
                 tiles_y, height, width, rgb.data_ptr(), t_final.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    cuda_lib.LAUNCHES[KERNEL] += 1
    return rgb, t_final
