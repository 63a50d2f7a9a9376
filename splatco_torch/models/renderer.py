"""Neural-gaussian decode + render (counterpart of
splatco_tpu/models/renderer.py).  `backend="cuda"` blends through the
binned tile kernels (ops/rasterize.py), `backend="dense"` through the
O(N*H*W) compositor (ops/rasterize_reference.py).

As in the JAX package, every anchor stays in its padded [C, ...] slot and
masking works by zeroing opacity: the binner emits no pairs for radius 0,
so masked gaussians cost nothing downstream.

The viewspace proxy reproduces the reference's screen-space points trick:
the caller passes zeros [C*K, 2] that require grad, they are added to the
projected means, and their gradient is the per-gaussian screen-space
gradient the densification statistics read.

`render` runs inside `torch.profiler.record_function("render")`, and the
decode (`generate_neural_gaussians`, `precompute_plane_feats`) inside
`record_function("decode")`, so that a profiler trace shows each frame
and each decode; a decode replayed as a CUDA graph
(models/decode_graph.py) also opens `record_function("decode_graph")`
inside it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from splatco_torch.data.cameras import Camera
from splatco_torch.models import decode_graph
from splatco_torch.models import decoders as dec
from splatco_torch.models.context_grid import spatial_ctx
from splatco_torch.models.contraction import Contractor, contract
from splatco_torch.models.triplane import (feature_planes_forward,
                                           sample_level_feats)
from splatco_torch.ops.projection import (project_gaussians_cols,
                                          visible_filter)
from splatco_torch.ops.rasterize import rasterize
from splatco_torch.ops.rasterize_reference import rasterize_dense
from splatco_torch.train.optimizer import tree_leaves
from splatco_torch.utils.math import normalize

BACKENDS = ("cuda", "dense")
# the tile the dense backend culls by, the JAX package's (32 px in both
# rasterizer configurations)
DENSE_TILE = 32


class RenderOutput(NamedTuple):
    image: torch.Tensor           # [3,H,W]
    neural_opacity: torch.Tensor  # [C*K] raw tanh output
    selection_mask: torch.Tensor  # [C*K] bool: opacity>0 & visible
    scaling: torch.Tensor         # [C*K,3] final gaussian scales
    radii: torch.Tensor           # [C*K] int32 (0 for masked)
    visibility_filter: torch.Tensor  # [C*K] bool radii>0
    num_overflow: int             # always 0 (no static slot budget)
    max_slots: torch.Tensor       # [] most reach-valid tiles of a gaussian
    class_counts: Optional[torch.Tensor] = None  # always None here
    num_clipped: Optional[torch.Tensor] = None   # [] gaussians whose tile
                                                 #   rect was clipped
    num_pairs: Optional[int] = None  # (tile, gaussian) records blended


def prefilter_voxel(anchors: Dict[str, torch.Tensor], active: torch.Tensor,
                    camera: Camera) -> torch.Tensor:
    """Anchor frustum culling: EWA-project anchors with base scales cols
    0-2 and the anchor rotation, keep radii > 0."""
    scales = torch.exp(anchors["scaling"])[:, :3]
    quats = normalize(anchors["rotation"], eps=1e-12)
    return visible_filter(anchors["anchor"], scales, quats, camera) & active


def anchor_plane_coords(params, contractor: Contractor,
                        compat_raw_domain: bool = False) -> torch.Tensor:
    """Anchor coords in the tri-plane query domain (view-independent)."""
    anchor = params["anchors"]["anchor"]
    if compat_raw_domain:
        return anchor
    return contract(contractor, anchor) * 2.0


def precompute_plane_feats(params, contractor: Contractor,
                           activate_level: int,
                           compat_raw_domain: bool = False):
    """View-independent tri-plane sampling, computed once and shared by
    every view of the same params."""
    with torch.profiler.record_function("decode"):
        xyz_norm = anchor_plane_coords(params, contractor, compat_raw_domain)
        return sample_level_feats(params["planes"], xyz_norm, activate_level)


def generate_neural_gaussians(
    params: Dict[str, Any],
    contractor: Contractor,
    camera: Camera,
    visible_mask: torch.Tensor,
    *,
    activate_level: int,
    add_opacity_dist: bool = False,
    add_cov_dist: bool = False,
    add_color_dist: bool = False,
    appearance_dim: int = 0,
    use_feat_bank: bool = False,
    compat_raw_domain: bool = False,
    use_spatial_ctx: bool = False,
    plane_feats=None,
    q_noise: float = 0.0,
    generator: Optional[torch.Generator] = None,
    group=None,
) -> Dict[str, torch.Tensor]:
    """Decode anchors -> per-offset gaussians (padded, masked).  Returns
    xyz [C*K,3], color, opacity (masked), scaling, rot, neural_opacity,
    mask.  q_noise > 0 with a generator adds the tri-plane quantization
    noise (training).  `group` (parallel/collectives.Group), when the
    anchors are one shard of a gauss axis, sums the fusion heads'
    BatchNorm statistics over that axis.  Without autograd on a card,
    the decode is replayed as one CUDA graph where it can be
    (models/decode_graph.py), with the same results."""
    flags = dict(activate_level=activate_level,
                 add_opacity_dist=add_opacity_dist, add_cov_dist=add_cov_dist,
                 add_color_dist=add_color_dist, appearance_dim=appearance_dim,
                 use_feat_bank=use_feat_bank,
                 compat_raw_domain=compat_raw_domain,
                 use_spatial_ctx=use_spatial_ctx)
    anchor = params["anchors"]["anchor"]

    def eager(mask, center):
        return _decode(params, contractor, center, camera.uid, mask,
                       plane_feats=plane_feats, q_noise=q_noise,
                       generator=generator, group=group, **flags)

    with torch.profiler.record_function("decode"):
        inputs = (visible_mask, camera.camera_center)
        key = None
        if decode_graph.engages(anchor, q_noise, generator, group,
                                plane_feats):
            key = decode_graph.key_of(
                tree_leaves(params) + [contractor.xyz_min,
                                       contractor.xyz_max], inputs,
                contractor.enabled,
                camera.uid if appearance_dim > 0 else None,
                *sorted(flags.items()))
        return decode_graph.decode(eager, inputs, key, anchor)


def _decode(params, contractor: Contractor, camera_center: torch.Tensor,
            camera_uid: int, visible_mask: torch.Tensor, *,
            activate_level: int, add_opacity_dist: bool, add_cov_dist: bool,
            add_color_dist: bool, appearance_dim: int, use_feat_bank: bool,
            compat_raw_domain: bool, use_spatial_ctx: bool, plane_feats,
            q_noise: float, generator: Optional[torch.Generator], group
            ) -> Dict[str, torch.Tensor]:
    """`generate_neural_gaussians`, eagerly, with the camera's centre
    and uid in place of the camera."""
    anchors = params["anchors"]
    anchor = anchors["anchor"]
    feat = anchors["feat"]
    offsets = anchors["offsets"]
    c, k, _ = offsets.shape
    grid_scaling = torch.exp(anchors["scaling"])

    xyz_norm = anchor_plane_coords(params, contractor, compat_raw_domain)
    if use_spatial_ctx:
        # per level, the context grids of the anchor features over the
        # contracted domain
        g_fea = tuple(spatial_ctx(xyz_norm, feat, -2.0, 2.0, level=i,
                                  mask=visible_mask)
                      for i in range(activate_level + 1))
    else:
        g_fea = torch.cat([feat, anchor, offsets.reshape(c, -1),
                           grid_scaling], dim=1)
    geo_fea = feature_planes_forward(
        params["planes"], xyz_norm, g_fea, visible_mask,
        activate_level=activate_level, plane_feats=plane_feats, q=q_noise,
        generator=generator, group=group)

    ob_view = anchor - camera_center
    ob_dist = torch.linalg.vector_norm(ob_view, dim=1, keepdim=True)
    ob_view = ob_view / torch.clamp_min(ob_dist, 1e-12)

    if use_feat_bank:
        bank_w = dec.feature_bank_mlp(
            params["decoders"], torch.cat([ob_view, ob_dist], dim=1)
        )[:, None, :]  # [C,1,3]
        f = feat[:, :, None]
        feat = (f[:, ::4, :1].repeat(1, 4, 1) * bank_w[:, :, :1]
                + f[:, ::2, :1].repeat(1, 2, 1) * bank_w[:, :, 1:2]
                + f[:, ::1, :1] * bank_w[:, :, 2:]).squeeze(-1)

    cat_local = torch.cat([feat, ob_view, ob_dist, geo_fea], dim=1)
    cat_local_wod = torch.cat([feat, ob_view, geo_fea], dim=1)

    neural_opacity = dec.opacity_mlp(
        params["decoders"],
        cat_local if add_opacity_dist else cat_local_wod
    ).reshape(-1)  # [C*K]
    mask = (neural_opacity > 0.0) & visible_mask.repeat_interleave(k)
    opacity = torch.where(mask, neural_opacity, 0.0)

    color_in = cat_local if add_color_dist else cat_local_wod
    if appearance_dim > 0:
        app = dec.appearance_embedding(params["decoders"], camera_uid, c)
        color_in = torch.cat([color_in, app], dim=1)
    color = dec.color_mlp(params["decoders"], color_in).reshape(c * k, 3)

    scale_rot = dec.cov_mlp(
        params["decoders"], cat_local if add_cov_dist else cat_local_wod
    ).reshape(c * k, 7)

    # each anchor row repeated k times, as an expand (its backward is a
    # sum over k, deterministic on the card)
    def rep(a):
        return a[:, None].expand(c, k, a.shape[1]).reshape(c * k, -1)

    scaling_rep = rep(grid_scaling)  # [C*K,6]
    anchor_rep = rep(anchor)
    scaling = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = normalize(scale_rot[:, 3:7], eps=1e-12)
    xyz = anchor_rep + offsets.reshape(c * k, 3) * scaling_rep[:, :3]
    return {
        "xyz": xyz, "color": color, "opacity": opacity, "scaling": scaling,
        "rot": rot, "neural_opacity": neural_opacity, "mask": mask,
    }


def rasterize_backend(backend: str, proj, colors, opacities, bg,
                      image_height: int, image_width: int, kmax: int,
                      tile16: Optional[bool] = None):
    """(image, aux) of `backend`: the tile kernels' counters, or the dense
    compositor's (nothing clipped, max_slots kmax, no records)."""
    if backend == "dense":
        image, _ = rasterize_dense(proj, colors, opacities, bg,
                                   image_height, image_width,
                                   tile_size=DENSE_TILE)
        zero = torch.zeros((), dtype=torch.int64, device=image.device)
        return image, {"num_overflow": 0, "max_slots": zero + kmax,
                       "num_clipped": zero, "num_pairs": None}
    return rasterize(proj, colors, opacities, bg, image_height, image_width,
                     kmax=kmax, return_aux=True, tile16=tile16)


def render(
    params: Dict[str, Any],
    active: torch.Tensor,
    contractor: Contractor,
    camera: Camera,
    bg: torch.Tensor,
    visible_mask: Optional[torch.Tensor] = None,
    viewspace_proxy: Optional[torch.Tensor] = None,
    *,
    activate_level: int = 0,
    is_training: bool = False,
    q_noise: float = 0.03,
    generator: Optional[torch.Generator] = None,
    kmax: int = 12,
    plane_feats=None,
    tile16: Optional[bool] = None,
    backend: str = "cuda",
    scale_modifier: float = 1.0,
    **decode_kwargs,
) -> RenderOutput:
    """Full render: decode -> EWA projection -> binning -> blend.  In
    training (`is_training`) the tri-plane features get U(-1/2, 1/2) *
    q_noise noise drawn from `generator`; eval uses q = 0.
    `viewspace_proxy` [C*K, 2], when given, is added to the projected
    means (see the module docstring).  `tile16` picks the rasterizer
    configuration (ops/rasterize.py; None: the SPLATCO_RASTER switch).
    `backend="dense"` blends with the dense compositor instead (culled by
    32 px tile rects, never clipped): its num_clipped is 0 and its
    max_slots kmax, as in the JAX package.  `scale_modifier` multiplies
    the decoded scales before the projection (the rasterizer setting the
    SIBR viewer drives); `RenderOutput.scaling` is the scaled value."""
    with torch.profiler.record_function("render"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        if visible_mask is None:
            visible_mask = active
        g = generate_neural_gaussians(
            params, contractor, camera, visible_mask,
            activate_level=activate_level, plane_feats=plane_feats,
            q_noise=q_noise if is_training else 0.0, generator=generator,
            **decode_kwargs)
        if scale_modifier != 1.0:
            g["scaling"] = g["scaling"] * scale_modifier

        proj = project_gaussians_cols(g["xyz"], g["scaling"], g["rot"], camera)
        radius = torch.where(g["opacity"] > 0.0, proj.radius, 0.0)
        mx, my = proj.mx, proj.my
        if viewspace_proxy is not None:
            mx = mx + viewspace_proxy[:, 0]
            my = my + viewspace_proxy[:, 1]
        proj = proj._replace(mx=mx, my=my, radius=radius)
        image, aux = rasterize_backend(
            backend, proj, g["color"], g["opacity"], bg, camera.image_height,
            camera.image_width, kmax, tile16)
        radii = radius.to(torch.int32)
        return RenderOutput(
            image=image,
            neural_opacity=g["neural_opacity"],
            selection_mask=g["mask"],
            scaling=g["scaling"],
            radii=radii,
            visibility_filter=radii > 0,
            num_overflow=aux["num_overflow"],
            max_slots=aux["max_slots"],
            num_clipped=aux["num_clipped"],
            num_pairs=aux["num_pairs"],
        )
