#!/usr/bin/env python
"""Popping-detection CLI of the PyTorch/CUDA port (detect_popping.py's
arguments, plus --device): temporal flow-warped consistency over an
ordered stream of rendered frames, written to --out as JSON.

    python3 detect_popping_torch.py --render_dir <frames> [--gt_dir <gt>] \
        [--flow raft --weights raft-things.pth] [--device cpu]

Runs on the card unless --device cpu is given.  --flow farneback (the
default) needs OpenCV; --flow raft runs the port's RAFT with the weights
of an official checkpoint on the device."""
import argparse
import json

from splatco_torch.eval.popping import flow_farneback, validate_popping


def main(argv=None):
    p = argparse.ArgumentParser(
        description="SplatCo popping detection (PyTorch/CUDA)")
    p.add_argument("--render_dir", required=True,
                   help="directory of ordered rendered frames")
    p.add_argument("--gt_dir", default=None,
                   help="optional GT frame stream for calibration")
    p.add_argument("--steps", nargs="+", type=int, default=[1, 7])
    p.add_argument("--out", default="popping_results.json")
    p.add_argument("--flow", default="farneback",
                   choices=["farneback", "raft"],
                   help="flow estimator: OpenCV Farneback (no weights "
                   "needed) or RAFT (needs --weights)")
    p.add_argument("--weights", default=None,
                   help="path to an official RAFT checkpoint "
                   "(raft-things.pth)")
    p.add_argument("--iters", type=int, default=20,
                   help="RAFT refinement iterations")
    p.add_argument("--plot_dir", default=None,
                   help="write per-frame MSE/FLIP curve PNGs here")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.flow == "raft":
        from splatco_torch.eval.raft import load_raft_weights, make_flow_fn

        if not args.weights:
            p.error("--flow raft requires --weights <ckpt.pth>")
        flow_fn = make_flow_fn(load_raft_weights(args.weights,
                                                 device=args.device),
                               iters=args.iters, device=args.device)
    else:
        flow_fn = flow_farneback
    res = validate_popping(args.render_dir, args.gt_dir,
                           steps=tuple(args.steps), out_json=args.out,
                           flow_fn=flow_fn, plot_dir=args.plot_dir,
                           device=args.device)
    for step, r in res.items():
        print(step, json.dumps(r["aggregate"]))
    return res


if __name__ == "__main__":
    main()
