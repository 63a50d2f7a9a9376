#!/usr/bin/env python
"""Metrics CLI of the PyTorch/CUDA port (metrics.py's arguments): PSNR,
SSIM, LPIPS and FLIP of each model's test renders against their ground
truth, written to <model>/results.json and per_view.json.

    python3 metrics_torch.py -m <model_dir> [--lpips_weights vgg.npz] \
        [--device cpu]

Runs on the card unless --device cpu is given.  LPIPS needs an .npz of
VGG16 and lin weights (--lpips_weights or SPLATCO_LPIPS_WEIGHTS);
without one it is recorded as null."""
import argparse

from splatco_torch.eval.metrics_driver import evaluate


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SplatCo metrics (PyTorch/CUDA)")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help=".npz from tools/export_lpips_weights.py")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.lpips_weights, device=args.device)


if __name__ == "__main__":
    main()
