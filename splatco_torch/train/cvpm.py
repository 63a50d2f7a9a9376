"""CVPM, the cross-view prune, and the curvature densification mask
(counterpart of splatco_tpu/train/cvpm.py).

  * `cvpm_pair_mask`: for one view pair (gated upstream on the ground
    truths' SSIM > 0.6), anchors closer than the threshold to BOTH cameras'
    baseline rays that are also too close to a camera (< 0.5) or are
    3-sigma outliers of the active cloud.  Camera centres by default; the
    trainer passes the world->cam T vectors under
    `ModelConfig.cvpm_compat_T`, the reference's as-shipped behaviour.
  * `knn_curvature`: per-anchor PCA curvature lambda_min / sum(lambda)
    over the k nearest neighbours, searched in a +-window rank window of
    the Morton order; anchors with curvature <= 0.1 extend the
    densification offset mask (`curvature_offset_mask`, anchor-major).
"""
from __future__ import annotations

import torch

from splatco_torch.ops.knn import _morton_bits

MORTON_SENTINEL = 0x7FFFFFFF


def cvpm_pair_mask(anchor: torch.Tensor, active: torch.Tensor,
                   cam_center1: torch.Tensor, cam_center2: torch.Tensor,
                   distance_threshold: float, min_cam_distance: float = 0.5,
                   sigma_threshold: float = 3.0) -> torch.Tensor:
    """Anchors inconsistent across one view pair.  Returns bool [C]:
    True = prune."""
    ray1 = cam_center2 - cam_center1
    ray2 = cam_center1 - cam_center2
    ray1 = ray1 / torch.clamp_min(torch.linalg.vector_norm(ray1), 1e-12)
    ray2 = ray2 / torch.clamp_min(torch.linalg.vector_norm(ray2), 1e-12)

    d1 = anchor - cam_center1[None]
    d2 = anchor - cam_center2[None]
    proj1 = cam_center1[None] + ray1[None] * (d1 @ ray1)[:, None]
    proj2 = cam_center2[None] + ray2[None] * (d2 @ ray2)[:, None]
    dist1 = torch.linalg.vector_norm(anchor - proj1, dim=1)
    dist2 = torch.linalg.vector_norm(anchor - proj2, dim=1)
    valid = (dist1 < distance_threshold) & (dist2 < distance_threshold)

    cam_d1 = torch.linalg.vector_norm(d1, dim=1)
    cam_d2 = torch.linalg.vector_norm(d2, dim=1)
    too_close = (cam_d1 < min_cam_distance) | (cam_d2 < min_cam_distance)

    m = active.to(anchor.dtype)[:, None]
    cnt = torch.clamp_min(m.sum(), 1.0)
    mean = (anchor * m).sum(dim=0) / cnt
    var = (((anchor - mean) ** 2) * m).sum(dim=0) / torch.clamp_min(
        cnt - 1.0, 1.0)
    std = torch.sqrt(var)
    outlier = ~torch.all((anchor - mean).abs() < sigma_threshold * std,
                         dim=1)
    return valid & (too_close | outlier) & active


def knn_curvature(points: torch.Tensor, active: torch.Tensor, k: int = 10,
                  window: int = 32) -> torch.Tensor:
    """PCA curvature over the k nearest neighbours (Morton-window search).
    Inactive rows get curvature 1.0 (never below the 0.1 threshold).

    The k nearest are taken by a stable ascending sort of the window's
    distances, so ties go to the lower window position, as `lax.top_k`
    breaks them."""
    n = points.shape[0]
    dev = points.device
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    q = ((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0
         ).to(torch.int32)
    code = torch.where(active, _morton_bits(q),
                       torch.tensor(MORTON_SENTINEL, dtype=torch.int32,
                                    device=dev))
    order = torch.argsort(code, stable=True)
    spts = points[order]
    sact = active[order]

    idx = torch.arange(n, device=dev)
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    nbr = torch.clamp(idx[:, None] + offs[None, :], 0, n - 1)   # [N, 2w]
    npts = spts[nbr]                                          # [N, 2w, 3]
    nact = sact[nbr]
    d2 = torch.sum((npts - spts[:, None]) ** 2, dim=-1)
    d2 = torch.where(nact & (nbr != idx[:, None]), d2, torch.inf)
    top_d2, top_idx = torch.sort(d2, dim=1, stable=True)
    top_d2, top_idx = top_d2[:, :k], top_idx[:, :k]
    sel = torch.take_along_dim(npts, top_idx[..., None], dim=1)  # [N,k,3]
    wgt = torch.isfinite(top_d2).to(points.dtype)[..., None]
    cnt = torch.clamp_min(wgt.sum(dim=1), 1.0)
    mean = (sel * wgt).sum(dim=1) / cnt
    cen = (sel - mean[:, None]) * wgt
    cov = torch.einsum("nka,nkb->nab", cen, cen) / torch.clamp_min(
        cnt[..., None] - 1.0, 1.0)
    ev = torch.linalg.eigvalsh(cov)                           # ascending
    curv = ev[:, 0] / torch.clamp_min(ev.sum(dim=1), 1e-12)
    curv = torch.where(sact, curv, 1.0)
    # undo the sort through the inverse permutation (an integer scatter of
    # a permutation, then a gather)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return curv[inv]


def curvature_offset_mask(points: torch.Tensor, active: torch.Tensor,
                          n_offsets: int, threshold: float = 0.1
                          ) -> torch.Tensor:
    """Anchor-major expansion of (curvature <= threshold) to the offset
    slots, [C*K] bool."""
    curv = knn_curvature(points, active)
    return torch.repeat_interleave(curv <= threshold, n_offsets)
