"""The 16 px blend forward with parts left out, for timing which part of
`raster_fwd16` costs the time (counterpart of the Pallas ablation `kern`
of tools/profile_kernel_v3.py; the port's tool is
tools/profile_torch_kernel_v3.py).

`raster_fwd16_ablate` launches `csrc/raster_fwd16_ablate.cu`, the
production forward template `fwd_kernel<16, variant>` of
`csrc/raster_tile.cuh`, for a CUDA tensor and runs the variant's plain
version for a CPU tensor.  Its inputs and outputs are `raster_fwd`'s at
tile 16.  Variants, each an exact function:

  full     raster_fwd16's: plain version `raster_fwd_plain(tile=16)`;
  nostage  the same image, each thread reading the records from device
           memory instead of a shared-memory batch (what JAX's `noroll`
           measured: the cost of bringing records to the arithmetic);
  noscan   no transmittance chain: T stays 1, a contributing record adds
           colour * alpha, and a pixel stops after the first record with
           alpha > 0.97, that record included; T_final is 1;
  noaccum  the chain and its termination without the colour sums: rgb 0,
           T_final as full's.

Launches count under `cuda_lib.LAUNCHES["raster_fwd16_ablate[<variant>]"]`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from splatco_torch.ops import cuda_lib
from splatco_torch.ops.rasterize_cuda import (ALPHA_MAX, ALPHA_MIN,
                                              _check_inputs, _pixel_grid,
                                              _untile, raster_fwd_plain)

KERNEL = "raster_fwd16_ablate"
TILE = 16
VARIANTS = ("full", "nostage", "noscan", "noaccum")
NOSCAN_STOP = 0.97


def noscan_plain(records: torch.Tensor, tile_start: torch.Tensor,
                 tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                 height: int, width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `noscan` variant in plain PyTorch, step l on the l-th record of
    every tile for all of its pixels at once (raster_fwd_plain's form)."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    px, py, live = _pixel_grid(tiles_x, tiles_y, height, width, dev, TILE)
    acc = torch.zeros((3, num_tiles, TILE * TILE), device=dev)
    start = tile_start.to(torch.int64)
    count = (tile_end - tile_start).to(torch.int64)
    steps = int(count.max()) if num_tiles else 0
    for step in range(steps):
        has = count > step
        rec = records[:, torch.where(has, start + step, 0)][:, :, None]
        mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        ok = live & has[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        acc = acc + rec[6:9] * torch.where(ok, alpha, 0.0)[None]
        live = live & ~(ok & (alpha > NOSCAN_STOP))
    hp, wp = tiles_y * TILE, tiles_x * TILE
    return (_untile(acc, tiles_x, tiles_y, TILE),
            torch.ones((hp, wp), device=dev))


def raster_fwd16_ablate_plain(records: torch.Tensor, tile_start: torch.Tensor,
                              tile_end: torch.Tensor, tiles_x: int,
                              tiles_y: int, height: int, width: int,
                              variant: str
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `variant`: (rgb [3, Hp, Wp], t_final [Hp, Wp])."""
    args = (records, tile_start, tile_end, tiles_x, tiles_y, height, width)
    if variant == "noscan":
        return noscan_plain(*args)
    rgb, t_final = raster_fwd_plain(*args, tile=TILE)
    if variant == "noaccum":
        rgb = torch.zeros_like(rgb)
    return rgb, t_final


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = getattr(cuda_lib.load(KERNEL), KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, ctypes.c_longlong, p, p, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def raster_fwd16_ablate(records: torch.Tensor, tile_start: torch.Tensor,
                        tile_end: torch.Tensor, tiles_x: int, tiles_y: int,
                        height: int, width: int, variant: str = "full"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 16 px blend's `variant` (one of VARIANTS) on the binned records:
    (rgb [3, Hp, Wp], t_final [Hp, Wp])."""
    variant_id = VARIANTS.index(variant)
    _check_inputs(records, tile_start, tile_end, tiles_x, tiles_y)
    if records.device.type == "cpu":
        return raster_fwd16_ablate_plain(records, tile_start, tile_end,
                                         tiles_x, tiles_y, height, width,
                                         variant)
    if records.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {records.device}")
    hp, wp = tiles_y * TILE, tiles_x * TILE
    rgb = torch.empty((3, hp, wp), dtype=torch.float32,
                      device=records.device)
    t_final = torch.empty((hp, wp), dtype=torch.float32,
                          device=records.device)
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = _kernel()(variant_id, records.data_ptr(), records.shape[1],
                        tile_start.data_ptr(), tile_end.data_ptr(), tiles_x,
                        tiles_y, height, width, rgb.data_ptr(),
                        t_final.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    cuda_lib.count_launch(f"{KERNEL}[{variant}]")
    return rgb, t_final
