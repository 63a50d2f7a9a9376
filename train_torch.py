#!/usr/bin/env python
"""Training CLI of the PyTorch/CUDA port (train.py's arguments; --backend
is cuda, the tile kernels, or dense).

    python3 train_torch.py -s <scene> -m out/run --mv 4 --num_channels 15 \
        --plane_size 2800 --no_downsample --contractor --bbox_scale 0.3 \
        --voxel_size 0 --update_init_factor 16 --appearance_dim 0

Trains on the card unless --device cpu is given; the rasterizer
configuration follows SPLATCO_RASTER (v3: 16 px tiles).  The scene's
camera lists are shuffled with a Random seeded by --seed, so a run and
its resumption (--start_checkpoint <model>/chkpnt<N>, a bare N, or
"latest") see the cameras in the same order.  A saved model renders with
render_torch.py, and loads in the JAX package too.  With the
SPLATCO_COORDINATOR / SPLATCO_NUM_PROCESSES / SPLATCO_PROCESS_ID variables
set, each process first joins the process group
(splatco_torch/parallel/distributed.py) and takes its own card.

--gui serves the SIBR network viewer on --ip:--port while it trains
(splatco_torch/viewer/network_gui.py): the viewer can pause and resume
training, scale the gaussians, and keep the server up past the last
iteration.  --profile records the run with torch.profiler (CPU, and CUDA
on the card) into <model_path or .>/profile_trace/trace.json, a Chrome
trace."""
import argparse
import os
import random

import torch

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig, add_dataclass_args,
                                  extract_dataclass)
from splatco_torch.data.scene import Scene
from splatco_torch.parallel.distributed import init_distributed
from splatco_torch.train.loop import Trainer, get_logger


def checkpoint_iteration(start_checkpoint: str) -> int:
    """The iteration of a --start_checkpoint argument (-1: the latest)."""
    if start_checkpoint == "latest":
        return -1
    tail = start_checkpoint.rsplit("chkpnt", 1)[-1].split(".")[0]
    return int(tail) if tail.isdigit() else -1


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(
        description="SplatCo training (PyTorch/CUDA)")
    add_dataclass_args(parser, ModelConfig())
    add_dataclass_args(parser, OptimizationConfig())
    add_dataclass_args(parser, PipelineConfig())
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[3000, 7000, 12000, 17000, 22000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--no_downsample", action="store_true")
    parser.add_argument("--no_multilevel", action="store_true")
    parser.add_argument("--no_regularization", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=["cuda", "dense"])
    parser.add_argument("--gui", action="store_true",
                        help="start the network viewer server")
    parser.add_argument("--profile", action="store_true",
                        help="record a torch.profiler trace of the run")
    parser.add_argument("--determinism_check", action="store_true",
                        help="run the step twice periodically and require "
                        "bit-identical results")
    parser.add_argument("--determinism_every", type=int, default=100)
    parser.add_argument("--wandb", action="store_true",
                        help="mirror TB scalars to wandb (if installed)")
    args = parser.parse_args(argv)

    # the multi-process runtime, when the SPLATCO_* variables ask for it
    init_distributed(device=args.device)

    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    model = extract_dataclass(args, ModelConfig)
    opt = extract_dataclass(args, OptimizationConfig)
    pipe = extract_dataclass(args, PipelineConfig)
    if args.no_downsample:
        opt.graph_downsampling_iters = []
    if args.iterations not in args.save_iterations:
        args.save_iterations.append(args.iterations)

    logger = get_logger(model.model_path or ".")
    logger.info(f"args: {vars(args)}")
    logger.info("Optimizing " + model.model_path)

    random.seed(args.seed)
    scene = Scene(model, device=args.device)
    trainer = Trainer(
        model, opt, pipe, logger=logger,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        no_multilevel=args.no_multilevel,
        no_regularization=args.no_regularization,
        determinism_check=args.determinism_check,
        determinism_every=args.determinism_every,
        use_wandb=args.wandb, device=args.device, backend=args.backend)
    trainer.setup(scene, seed=args.seed)
    if args.start_checkpoint:
        trainer.restore(iteration=checkpoint_iteration(
            args.start_checkpoint))
    if args.gui:
        from splatco_torch.viewer.network_gui import ViewerServer
        trainer.viewer = ViewerServer(trainer, args.ip, args.port)
        trainer.viewer.start()
    try:
        if args.profile:
            profile_run(trainer, model.model_path or ".")
        else:
            trainer.train()
    finally:
        if trainer.viewer is not None:
            trainer.viewer.stop()
    print("\nTraining complete.")
    return trainer


def profile_run(trainer: Trainer, out_dir: str) -> str:
    """trainer.train() under torch.profiler; returns the Chrome trace's
    path, <out_dir>/profile_trace/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if trainer.dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trainer.train()
    path = os.path.join(out_dir, "profile_trace", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


if __name__ == "__main__":
    main()
