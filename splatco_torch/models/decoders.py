"""Neural-gaussian attribute decoders + appearance embedding (counterpart
of splatco_tpu/models/decoders.py).  All consume the per-anchor local view
vector [feat | dir (| dist) | geo_fea(64)] and emit per-offset attributes
for the K = n_offsets gaussians of each anchor."""
from __future__ import annotations

from typing import Any, Dict

import torch

from splatco_torch.models.mlp import init_mlp, mlp

GEO_DIM = 64  # geo_fea width from CSCM (2 x 32)


def init_decoders(feat_dim: int, n_offsets: int, generator: torch.Generator,
                  appearance_dim: int = 0, use_feat_bank: bool = False,
                  add_opacity_dist: bool = False, add_cov_dist: bool = False,
                  add_color_dist: bool = False, num_cameras: int = 0
                  ) -> Dict[str, Any]:
    od = 1 if add_opacity_dist else 0
    cd = 1 if add_cov_dist else 0
    cld = 1 if add_color_dist else 0
    params = {
        "opacity": init_mlp([feat_dim + 3 + od + GEO_DIM, feat_dim,
                             n_offsets], generator),
        "cov": init_mlp([feat_dim + 3 + cd + GEO_DIM, feat_dim,
                         7 * n_offsets], generator),
        "color": init_mlp([feat_dim + 3 + cld + appearance_dim + GEO_DIM,
                           feat_dim, 3 * n_offsets], generator),
    }
    if use_feat_bank:
        params["feature_bank"] = init_mlp([3 + 1, feat_dim, 3], generator)
    if appearance_dim > 0:
        # per-camera appearance table, indexed by camera uid
        rows = max(num_cameras, 1)
        params["appearance"] = {
            "table": torch.randn((rows, appearance_dim), generator=generator)
        }
    return params


def opacity_mlp(params, x):
    return mlp(params["opacity"], x, final_act="tanh")


def cov_mlp(params, x):
    return mlp(params["cov"], x)


def color_mlp(params, x):
    return mlp(params["color"], x, final_act="sigmoid")


def feature_bank_mlp(params, x):
    return mlp(params["feature_bank"], x, final_act="softmax")


def appearance_embedding(params, cam_uid: int, n: int) -> torch.Tensor:
    table = params["appearance"]["table"]
    uid = min(max(int(cam_uid), 0), table.shape[0] - 1)
    return table[uid][None, :].expand(n, table.shape[1])
