"""Model configuration — this package's own copy of `splatco_tpu.config`'s
`ModelConfig` (same fields, same defaults), so a config saved by the
JAX trainer (the `model` part of `cfg_args.json`) builds one here
unchanged."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
    use_spatial_ctx: bool = False  # context-grid local branch (not ported)
    cvpm_compat_T: bool = False

