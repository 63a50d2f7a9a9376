#!/usr/bin/env python
"""Attribute the SVC training step's time by differencing (counterpart of
tools/profile_step_recon.py): the same step is timed whole and with each
block removed (make_train_step(disable=...): the SSIM term, the
consistency term, TV, the scale regulariser, the densification
statistics, the optimizer, and all six at once), and each block's cost
is the whole step's time less the step's time without it.

    python3 tools/profile_step_recon_torch.py [--device cpu] [--smoke]

The model (65,536 anchors of a seeded normal cloud, 10 offsets, plane
size 1024), mv = 4 views at 1600x1088 on a 3.5 radius orbit and random
targets are the JAX tool's; --smoke shrinks them (64 anchors, plane
size 16, 32x24, one timed step), as the JAX tool's
SPLATCO_BENCH_SMOKE=1 does.  Prints one JSON line: ms per step of each
variant and each block's delta.  On the card the times are CUDA events
(utils/measure.cuda_time_ms); with --device cpu they are the host
clock's, of the CPU."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from splatco_torch.config import (ModelConfig,  # noqa: E402
                                  OptimizationConfig)
from splatco_torch.data.cameras import look_at_camera  # noqa: E402
from splatco_torch.models.splatco import init_model  # noqa: E402
from splatco_torch.train.optimizer import (make_optimizer,  # noqa: E402
                                           tree_leaves)
from splatco_torch.train.step import (DISABLE, init_stats,  # noqa: E402
                                      make_train_step)
from splatco_torch.utils.device import resolve_device  # noqa: E402
from splatco_torch.utils.measure import cuda_time_ms  # noqa: E402

MV = 4
VARIANTS = {
    "full": (),
    "-ssim": ("ssim",),
    "-consistency": ("consistency",),
    "-tv": ("tv",),
    "-sreg": ("sreg",),
    "-stats": ("stats",),
    "-optimizer": ("optimizer",),
    "-all_aux": tuple(sorted(DISABLE)),
}


def time_variants(cfg, opt, params, state, cams, gts, bg, extent: float,
                  iters: int, dev) -> dict:
    """{variant: ms per step} of the level-0 step from `params`, each
    variant carrying its own optimizer state and statistics over one
    checked step, a warm-up and `iters` timed ones.  The params a
    variant without the optimizer returns must equal its input bit for
    bit."""
    tx = make_optimizer(opt, params, extent, 0, device=dev)
    n_pairs = MV * (MV - 1) // 2
    gates = torch.full((n_pairs,), 0.9, device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    out = {}
    for name, blocks in VARIANTS.items():
        step = make_train_step(cfg, opt, MV, 0, tx, device=dev,
                               disable=frozenset(blocks))
        carry = [tx.init(params), init_stats(
            params["anchors"]["anchor"].shape[0], cfg.n_offsets,
            device=dev)]
        gen = torch.Generator(device=dev).manual_seed(1)

        def run():
            p, carry[0], carry[1], m = step(
                params, carry[0], state.active, state.contractor, carry[1],
                cams, gts, bg, gen, 1000, 1.0, 0.0, 1.0, gates)
            return p, m

        p, m = run()
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"{name}: the loss is not finite")
        if "optimizer" in blocks and not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(p), before)):
            raise AssertionError(f"{name}: the params moved")
        if dev.type == "cuda":
            out[name] = cuda_time_ms(run, iters)
        else:
            run()  # the warm-up cuda_time_ms makes
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            out[name] = 1e3 * (time.perf_counter() - t0) / iters
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="a toy size, for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    capacity, plane_size, w, h, iters = ((64, 16, 32, 24, 1) if args.smoke
                                         else (65536, 1024, 1600, 1088, 4))

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(capacity, 3)).astype(np.float32) * 1.2
    cfg = ModelConfig(feat_dim=32, n_offsets=10, voxel_size=0.01,
                      plane_size=plane_size, num_channels=9,
                      appearance_dim=0, contractor=True,
                      scene_center=[0, 0, 0], scene_length=[4, 4, 4],
                      capacity=capacity)
    params, state = init_model(cfg, pts, device=dev,
                               generator=torch.Generator().manual_seed(0))
    cams = [look_at_camera([3.5 * np.sin(i), 0.4, -3.5 * np.cos(i)],
                           [0, 0, 0], [0, -1, 0], 1.2, 1.2 * h / w, w, h,
                           uid=i, device=dev) for i in range(MV)]
    gts = [torch.as_tensor(g, device=dev) for g in
           rng.uniform(size=(MV, 3, h, w)).astype(np.float32)]
    bg = torch.zeros(3, device=dev)
    ms = time_variants(cfg, OptimizationConfig(), params, state, cams, gts,
                       bg, 1.0, iters, dev)
    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "clock": "cuda_events" if dev.type == "cuda" else "host",
        "shape": {"capacity": capacity, "n_offsets": cfg.n_offsets,
                  "mv": MV, "width": w, "height": h},
        "ms": ms,
        "block_ms": {name[1:]: ms["full"] - v for name, v in ms.items()
                     if name != "full"},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
