#!/usr/bin/env python
"""Ablation timing of the 16 px blend forward (the v3 configuration's
`raster_fwd16`) at the JAX tool's scale, the port of
tools/profile_kernel_v3.py: which part of the kernel costs the time,
bringing records to the arithmetic (nostage), the transmittance chain
(noscan) or the colour sums (noaccum).  The variants are
splatco_torch/ops/raster_ablate.py's.

Scene (the JAX tool's): 2^19 gaussians, means N(0, 1) x 1.2, scales
0.001 + 0.004 U, random quaternions, colours U, opacity U(0.3, 0.95),
from np.random.default_rng(0); one look-at camera from (0, 0, -4) at
1600x1088, fov 1.2 rad; the port's `project_gaussians_cols` and
`raster_v3.bin_gaussians_v3` at kmax 24.

    python tools/profile_torch_kernel_v3.py [--iters N] [--n N]
        [--width W] [--height H] [--device cpu]

On the card each variant is timed with CUDA events (mean of --iters
launches after a warm-up) and printed with its us per tile beside the
bound that splatco_torch.utils.measure.fwd_bound gives from full's work
counts.  With
--device cpu it runs the plain versions and skips the timing.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from splatco_torch.data.cameras import look_at_camera  # noqa: E402
from splatco_torch.ops import raster_v3  # noqa: E402
from splatco_torch.ops.projection import project_gaussians_cols  # noqa: E402
from splatco_torch.ops.raster_ablate import (TILE, VARIANTS,  # noqa: E402
                                             raster_fwd16_ablate)
from splatco_torch.ops.rasterize_cuda import raster_fwd_plain  # noqa: E402
from splatco_torch.utils.device import resolve_device  # noqa: E402
from splatco_torch.utils.measure import cuda_time_ms, fwd_bound  # noqa: E402

KMAX = 24


def binned_scene(dev: torch.device, n: int = 1 << 19, width: int = 1600,
                 height: int = 1088):
    """The JAX tool's scene, projected and binned on the 16 px grid:
    (binned, tiles_x, tiles_y)."""
    rng = np.random.default_rng(0)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
    scales = (0.001 + 0.004 * rng.uniform(size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    cam = look_at_camera([0, 0, -4.0], [0, 0, 0], [0, -1, 0], 1.2,
                         1.2 * height / width, width, height, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    proj = project_gaussians_cols(t(means), t(scales), t(quats), cam)
    tiles_x, tiles_y = raster_v3.tile_grid(height, width)
    binned = raster_v3.bin_gaussians_v3(proj, t(colors), t(opac), tiles_x,
                                        tiles_y, kmax=KMAX)
    return binned, tiles_x, tiles_y


def run(dev: torch.device, iters: int = 20, n: int = 1 << 19,
        width: int = 1600, height: int = 1088) -> dict:
    """Launch every variant on the scene (once, then timed on the card),
    print one line each; returns {"binned", "grid", "args" (the variants'
    arguments), "work", "bound", "ms": {variant: ms or None}, "out":
    {variant: (rgb, t_final)}}."""
    binned, tiles_x, tiles_y = binned_scene(dev, n, width, height)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, height, width)
    num_tiles = tiles_x * tiles_y
    print(f"{n} gaussians at {width}x{height}: {binned.records.shape[1]} "
          f"pairs in {num_tiles} tiles of {TILE} px (kmax {KMAX}), clipped "
          f"{int(binned.num_clipped)}")
    res = {"binned": binned, "grid": (tiles_x, tiles_y), "args": args,
           "ms": {}, "out": {}}
    for variant in VARIANTS:
        res["out"][variant] = raster_fwd16_ablate(*args, variant=variant)
    if dev.type == "cuda":
        work = {}
        raster_fwd_plain(*args, work=work, tile=TILE)
        res["work"] = work
        res["bound"] = fwd_bound(binned, work, tiles_x, tiles_y, TILE)
    for variant in VARIANTS:
        rgb, t_fin = res["out"][variant]
        line = (f"fwd[{variant:8s}] rgb mean {float(rgb.mean()):.6f} "
                f"T mean {float(t_fin.mean()):.6f}")
        if dev.type == "cuda":
            ms = cuda_time_ms(
                lambda: raster_fwd16_ablate(*args, variant=variant), iters)
            res["ms"][variant] = ms
            line += (f"  {ms:8.4f} ms ({ms / num_tiles * 1e3:.3f} us/tile; "
                     f"bound {res['bound'][0]:.4f} ms, "
                     f"{res['bound'][0] / ms:.1%} of it)")
        print(line)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the card")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1088)
    args = ap.parse_args()
    run(resolve_device(args.device), args.iters, args.n, args.width,
        args.height)
    return 0


if __name__ == "__main__":
    sys.exit(main())
