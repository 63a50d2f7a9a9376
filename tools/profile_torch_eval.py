#!/usr/bin/env python
"""Profile the port's evaluation on the card at chip_smoke.py phase 17's
size (1600x1088): each metric's ms per image (PSNR, SSIM, FLIP and
FLIP's 14 convolutions alone, LPIPS at VGG16's widths), RAFT's stages
(the encoders, the all-pairs pyramid, one lookup, one update block, the
upsampling) and whole flows, with cuDNN's algorithms chosen by timing
(as eval/raft.py runs) or, with --cudnn heuristics, by its heuristics,
and the peak device memory of the first flow and of later ones.  Beside
each time, the operations torch counts in convolutions and matrix
products (torch.utils.flop_counter) and the bound they give at the
float32 peak.

    python tools/profile_torch_eval.py [--width 1600 --height 1088]
        [--iters 20] [--reps 3] [--cudnn timed|heuristics] [--device cpu]
        [--out PATH]

Inputs are seeded (a random image and its 3 px shift; random LPIPS and
RAFT weights), so the times are those of this work, not of a trained
model's.  With --device cpu each stage runs once at the size given and
nothing is timed."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from splatco_torch.eval import raft  # noqa: E402
from splatco_torch.ops import flip, lpips  # noqa: E402
from splatco_torch.ops.losses import psnr, ssim  # noqa: E402
from splatco_torch.utils.device import resolve_device  # noqa: E402
from splatco_torch.utils.measure import bound, cuda_time_ms  # noqa: E402


def flip_convs(a: torch.Tensor, b: torch.Tensor):
    """FLIP's 14 convolutions at these images' size: the three CSF
    filters on each image's channels and the edge and point filters
    along x and y on each image's luminance."""
    s_a, s_rg, s_by, r = flip._csf_filters(flip.DEFAULT_PPD)
    out = []
    for img in (a, b):
        out += [flip._conv2d_replicate(img[c], k, r)
                for c, k in enumerate((s_a, s_rg, s_by))]
        for feature in ("edge", "point"):
            gx, fr = flip._feature_kernel(flip.DEFAULT_PPD, feature)
            out += [flip._conv2d_replicate(img[0], gx, fr),
                    flip._conv2d_replicate(img[0], gx.T.copy(), fr)]
    return out


def flops_of(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def run(dev: torch.device, width: int, height: int, iters: int,
        reps: int, seed: int, heuristics: bool = False) -> dict:
    on_card = dev.type == "cuda"
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((3, height, width), generator=g).to(dev)
    b = torch.roll(a, 3, dims=2)
    w = {k: torch.from_numpy(v).to(dev)
         for k, v in lpips.random_weights(seed).items()}
    params = raft.init_raft_params(torch.Generator().manual_seed(seed),
                                   device=dev)
    img1, img2 = (255.0 * x[None] for x in (a, b))
    image_bytes = 2 * a.numel() * 4

    def timed(fn):
        if not on_card:
            fn()
            return None
        return cuda_time_ms(fn, reps)

    def peak_gib():
        """The peak since the last call, in GiB (None on the CPU)."""
        if not on_card:
            return None
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        return peak

    out = {"device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "size": [height, width], "iters": iters}
    with torch.inference_mode():
        # the metrics, per image
        metrics = {
            "PSNR": lambda: psnr(a, b), "SSIM": lambda: ssim(a, b),
            "FLIP": lambda: flip.ldr_flip(a, b),
            "FLIP convolutions": lambda: flip_convs(a, b),
            "LPIPS": lambda: lpips.lpips(w, a, b)}
        out["metrics"] = {}
        for name, fn in metrics.items():
            ops = flops_of(fn)
            bnd = bound(image_bytes, ops)
            out["metrics"][name] = {"ms": timed(fn), "flops": ops,
                                    "bound_ms": bnd[0], "bound_by": bnd[1]}

        # RAFT in one mode of cuDNN's algorithm choice: the first flow,
        # later flows, the stages
        algorithms = (torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False) if heuristics else raft._timed_algorithms())
        out["cudnn"] = "heuristics" if heuristics else "timed"
        x = 2.0 * (img1 / 255.0) - 1.0
        peak_gib()
        with algorithms:
            flow = raft._raft_flow(params, img1, img2, iters)
            out["first_flow_peak_gib"] = peak_gib()
            ops = flops_of(lambda: raft._raft_flow(params, img1, img2,
                                                   iters))
            flow_bytes = image_bytes + flow.numel() * 4 + 4 * sum(
                v.numel() for v in params.values())
            bnd = bound(flow_bytes, ops)
            out["raft_flow"] = {
                "ms": timed(lambda: raft._raft_flow(params, img1, img2,
                                                    iters)),
                "flops": ops, "bound_ms": bnd[0], "bound_by": bnd[1]}
            out["steady_flow_peak_gib"] = peak_gib()
            fmap = raft.basic_encoder(params, "fnet", x, "instance")
            pyr = raft.build_corr_pyramid(fmap, fmap)
            _, _, h, w8 = fmap.shape
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w8, dtype=torch.float32, device=dev),
                indexing="ij")
            coords = torch.stack([gx, gy])
            corr = raft.lookup_corr(pyr, coords)
            net = torch.zeros((1, raft.HDIM, h, w8), device=dev)
            zero_flow = torch.zeros((1, 2, h, w8), device=dev)
            _, mask, _ = raft.update_block(params, net, net, corr, zero_flow)
            stages = {
                "fnet encoder": lambda: raft.basic_encoder(
                    params, "fnet", x, "instance"),
                "cnet encoder": lambda: raft.basic_encoder(
                    params, "cnet", x, "batch"),
                "pyramid": lambda: raft.build_corr_pyramid(fmap, fmap),
                "lookup": lambda: raft.lookup_corr(pyr, coords),
                "update block": lambda: raft.update_block(
                    params, net, net, corr, zero_flow),
                "upsample": lambda: raft.upsample_flow(zero_flow, mask)}
            out["raft_stages_ms"] = {k: timed(fn)
                                     for k, fn in stages.items()}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cudnn", default="timed",
                    choices=["timed", "heuristics"],
                    help="how cuDNN picks RAFT's convolution algorithms; "
                    "one mode a process, as cuDNN caches a shape's plan "
                    "across the two")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run(dev, args.width, args.height, args.iters, args.reps,
              args.seed, heuristics=args.cudnn == "heuristics")
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return res


if __name__ == "__main__":
    main()
