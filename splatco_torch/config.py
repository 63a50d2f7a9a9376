"""Configuration — this package's own copies of `splatco_tpu.config`'s
`ModelConfig`, `PipelineConfig` and `OptimizationConfig` (same fields,
same defaults), its dataclass-reflection CLI and its JSON run
persistence, so a `cfg_args.json` written by either package loads in the
other."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List

SHORTHANDS = {
    "source_path": "-s", "model_path": "-m", "images": "-i",
    "resolution": "-r", "white_background": "-w",
}


@dataclass
class ModelConfig:
    # reference ModelParams
    sh_degree: int = 3
    feat_dim: int = 32
    n_offsets: int = 10
    voxel_size: float = 0.001  # <=0: use median 3-NN distance
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    use_feat_bank: bool = False
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = True
    num_channels: int = 9
    plane_size: int = 2500
    subplane_multiplier: int = 1
    mlp_dim: int = 168
    bbox_scale: float = 0.8
    data_device: str = "cpu"
    eval: bool = True
    lod: int = 0
    scene_center: List[float] = field(
        default_factory=lambda: [-0.0130, 0.0044, 0.2562])
    scene_length: List[float] = field(
        default_factory=lambda: [1.2932, 2.2867, 1.4900])
    contractor: bool = False
    appearance_dim: int = 32
    lowpoly: bool = False
    ds: int = 1
    ratio: int = 1
    undistorted: bool = False
    add_opacity_dist: bool = False
    add_cov_dist: bool = False
    add_color_dist: bool = False
    capacity: int = 0            # anchor capacity (0 = auto from init count)
    max_capacity: int = 0        # cap on densify capacity regrowth
    quirk_duplicate_level0: bool = True   # reference pyramid quirk
    compat_raw_domain: bool = False       # query planes in raw coords
    kmax: int = 12               # rasterizer tiles-per-gaussian budget
    use_spatial_ctx: bool = False  # context-grid local branch
    cvpm_compat_T: bool = False


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    mv: int = 4


@dataclass
class OptimizationConfig:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 30_000
    feature_lr: float = 0.0075
    opacity_lr: float = 0.02
    scaling_lr: float = 0.007
    rotation_lr: float = 0.002
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_delay_mult: float = 0.01
    mlp_opacity_lr_max_steps: int = 30_000
    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_delay_mult: float = 0.01
    mlp_cov_lr_max_steps: int = 30_000
    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_delay_mult: float = 0.01
    mlp_color_lr_max_steps: int = 30_000
    mlp_featurebank_lr_init: float = 0.01
    mlp_featurebank_lr_final: float = 0.00001
    mlp_featurebank_lr_delay_mult: float = 0.01
    mlp_featurebank_lr_max_steps: int = 30_000
    appearance_lr_init: float = 0.05
    appearance_lr_final: float = 0.0005
    appearance_lr_delay_mult: float = 0.01
    appearance_lr_max_steps: int = 30_000
    start_stat: int = 500
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 15_000
    min_opacity: float = 0.005
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    datarate_lambda: float = 0.0001
    tv_weight_a: float = 4e-7
    tv_weight_b: float = 5e-8
    pc_downsamplerate: float = 0.65
    quantization: int = 1
    graph_downsampling_iters: List[int] = field(
        default_factory=lambda: [11000])
    # plane LRs (the reference hardcodes them in its optimizer setup)
    plane_lr_active: float = 0.01
    plane_lr_inactive: float = 0.001
    plane_mlp_lr_active: float = 1e-4
    plane_mlp_lr_inactive: float = 1e-5


def add_dataclass_args(parser: argparse.ArgumentParser, cfg, prefix: str = ""
                       ) -> None:
    for f in dataclasses.fields(cfg):
        name = "--" + f.name
        default = getattr(cfg, f.name)
        flags = [name]
        if f.name in SHORTHANDS:
            flags.append(SHORTHANDS[f.name])
        if isinstance(default, bool):
            parser.add_argument(*flags, action="store_true", default=default)
        elif isinstance(default, list):
            parser.add_argument(*flags, nargs="+",
                                type=type(default[0]) if default else float,
                                default=default)
        else:
            parser.add_argument(*flags, type=type(default), default=default)


def extract_dataclass(args: argparse.Namespace, cls):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name):
            kwargs[f.name] = getattr(args, f.name)
    return cls(**kwargs)


def save_run_config(model_path: str, model: ModelConfig,
                    pipeline: PipelineConfig, opt: OptimizationConfig
                    ) -> None:
    os.makedirs(model_path, exist_ok=True)
    payload = {
        "model": dataclasses.asdict(model),
        "pipeline": dataclasses.asdict(pipeline),
        "optimization": dataclasses.asdict(opt),
    }
    with open(os.path.join(model_path, "cfg_args.json"), "w") as fh:
        json.dump(payload, fh, indent=2)


def load_run_config(model_path: str):
    path = os.path.join(model_path, "cfg_args.json")
    with open(path) as fh:
        payload = json.load(fh)
    return (ModelConfig(**payload["model"]),
            PipelineConfig(**payload["pipeline"]),
            OptimizationConfig(**payload["optimization"]))


def combined_config(args: argparse.Namespace):
    """Render-time config: the saved run config overridden by the CLI
    arguments that differ from the defaults."""
    model_path = getattr(args, "model_path", "")
    try:
        model, pipeline, opt = load_run_config(model_path)
    except (FileNotFoundError, TypeError):
        model, pipeline, opt = (ModelConfig(), PipelineConfig(),
                                OptimizationConfig())
    defaults = (ModelConfig(), PipelineConfig(), OptimizationConfig())
    for cfg, dflt in zip((model, pipeline, opt), defaults):
        for f in dataclasses.fields(cfg):
            if hasattr(args, f.name):
                v = getattr(args, f.name)
                if v != getattr(dflt, f.name) and v is not None:
                    setattr(cfg, f.name, v)
    return model, pipeline, opt
