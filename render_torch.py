#!/usr/bin/env python
"""Offline render CLI of the PyTorch/CUDA port (render.py's arguments;
--backend is cuda, the tile kernels, or dense): renders a trained model's train and test views of a
COLMAP or Blender scene, writes per-view PNGs and num_gaussians.json.

    python3 render_torch.py -m <model_dir> [-s <scene>] [--device cpu]
        [--backend dense]

Runs on the card unless --device cpu is given; the rasterizer
configuration follows SPLATCO_RASTER (v3: 16 px tiles)."""
import argparse

from splatco_torch.config import (ModelConfig, add_dataclass_args,
                                  combined_config)
from splatco_torch.eval.render_driver import render_sets


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SplatCo rendering (PyTorch/CUDA)")
    add_dataclass_args(parser, ModelConfig())
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=["cuda", "dense"])
    args = parser.parse_args(argv)
    model, _pipe, _opt = combined_config(args)
    print("Rendering " + model.model_path)
    fps, n = render_sets(model, args.iteration, args.skip_train,
                         args.skip_test, device=args.device,
                         backend=args.backend)
    print(f"anchors: {n}, fps: {fps}")


if __name__ == "__main__":
    main()
