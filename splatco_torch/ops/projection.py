"""EWA projection stage of the Gaussian rasterizer (counterpart of
splatco_tpu/ops/projection.py, the columnwise `project_cols` path).

  * row-vector convention: p_hom = [p,1] @ full_proj (matrices stored
    transposed, see data/cameras.py),
  * near-plane cull at p_view.z <= 0.2,
  * EWA: cov2D = (J W Sigma W^T J^T)[:2,:2] with the +-1.3*tan(fov)
    frustum clamp on t.x/t.z, t.y/t.z before building J,
  * low-pass dilation cov2D += 0.3 * I,
  * radius = ceil(3 * sqrt(lambda_max)), lambda_max = mid + sqrt(max(0.1,
    mid^2 - det)), and an on-screen test of the radius square,
  * ndc2Pix(v, S) = ((v + 1) * S - 1) / 2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_CLIP = 0.2
LOWPASS = 0.3


class ProjectedCols(NamedTuple):
    """SoA screen-space quantities: seven [N] float32 columns."""
    mx: torch.Tensor      # pixel x
    my: torch.Tensor      # pixel y
    depth: torch.Tensor   # view z
    ca: torch.Tensor      # conic a
    cb: torch.Tensor      # conic b
    cc: torch.Tensor      # conic c
    radius: torch.Tensor  # float32, 0 => culled


def covariance_cols(scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = R diag(s^2) R^T as 6 columns (xx, xy, xz, yy, yz, zz)."""
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]
    n = torch.sqrt(quats[:, 0] ** 2 + quats[:, 1] ** 2 + quats[:, 2] ** 2
                   + quats[:, 3] ** 2)
    n = torch.clamp_min(n, 1e-12)
    w, x, y, z = (quats[:, i] / n for i in range(4))
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2

    def sig(ra, rb, rc, qa, qb, qc):
        return v0 * ra * qa + v1 * rb * qb + v2 * rc * qc

    xx = sig(r00, r01, r02, r00, r01, r02)
    xy = sig(r00, r01, r02, r10, r11, r12)
    xz = sig(r00, r01, r02, r20, r21, r22)
    yy = sig(r10, r11, r12, r10, r11, r12)
    yz = sig(r10, r11, r12, r20, r21, r22)
    zz = sig(r20, r21, r22, r20, r21, r22)
    return xx, xy, xz, yy, yz, zz


def project_cols(means3d: torch.Tensor, cov6, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor, image_width: int,
                 image_height: int, tan_fovx: float, tan_fovy: float
                 ) -> ProjectedCols:
    """Columnwise EWA projection of [N] gaussians; `cov6` from
    covariance_cols."""
    px_, py_, pz_ = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)
    vm = viewmatrix
    pm = projmatrix

    def xform(m, col):
        return (px_ * m[0, col] + py_ * m[1, col] + pz_ * m[2, col]
                + m[3, col])

    tx_v = xform(vm, 0)
    ty_v = xform(vm, 1)
    tz = xform(vm, 2)
    in_front = tz > NEAR_CLIP

    hx = xform(pm, 0)
    hy = xform(pm, 1)
    hw = xform(pm, 3)
    p_w = 1.0 / (hw + 1e-7)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    safe_z = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    tx = torch.clamp(tx_v / safe_z, -limx, limx) * tz
    ty = torch.clamp(ty_v / safe_z, -limy, limy) * tz
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z

    # M = J @ W rows (W = world->cam rotation = viewmatrix[:3,:3]^T)
    a0 = focal_x * inv_z
    a2 = -focal_x * tx * inv_z2
    b1 = focal_y * inv_z
    b2 = -focal_y * ty * inv_z2
    m00 = a0 * vm[0, 0] + a2 * vm[0, 2]
    m01 = a0 * vm[1, 0] + a2 * vm[1, 2]
    m02 = a0 * vm[2, 0] + a2 * vm[2, 2]
    m10 = b1 * vm[0, 1] + b2 * vm[0, 2]
    m11 = b1 * vm[1, 1] + b2 * vm[1, 2]
    m12 = b1 * vm[2, 1] + b2 * vm[2, 2]

    xx, xy, xz, yy, yz, zz = cov6

    def quad(u0, u1, u2, w0, w1, w2):
        return (u0 * (xx * w0 + xy * w1 + xz * w2)
                + u1 * (xy * w0 + yy * w1 + yz * w2)
                + u2 * (xz * w0 + yz * w1 + zz * w2))

    cov00 = quad(m00, m01, m02, m00, m01, m02) + LOWPASS
    cov01 = quad(m00, m01, m02, m10, m11, m12)
    cov11 = quad(m10, m11, m12, m10, m11, m12) + LOWPASS

    det = cov00 * cov11 - cov01 * cov01
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic_a = cov11 * inv_det
    conic_b = -cov01 * inv_det
    conic_c = cov00 * inv_det

    mid = 0.5 * (cov00 + cov11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    mx = ((hx * p_w + 1.0) * image_width - 1.0) * 0.5
    my = ((hy * p_w + 1.0) * image_height - 1.0) * 0.5
    on_screen = ((mx + radius_f > 0) & (mx - radius_f < image_width)
                 & (my + radius_f > 0) & (my - radius_f < image_height))
    visible = in_front & det_ok & on_screen
    radius = torch.where(visible, radius_f, 0.0)
    return ProjectedCols(mx=mx, my=my, depth=tz, ca=conic_a, cb=conic_b,
                         cc=conic_c, radius=radius)


def project_gaussians_cols(means3d, scales, quats, camera) -> ProjectedCols:
    """scales/quats -> covariance columns -> columnwise EWA."""
    return project_cols(
        means3d, covariance_cols(scales, quats),
        camera.world_view_transform, camera.full_proj_transform,
        camera.image_width, camera.image_height,
        camera.tan_fovx, camera.tan_fovy,
    )


def visible_filter(means3d, scales, quats, camera) -> torch.Tensor:
    """Frustum/extent cull without shading (the prefilter).  bool [N]."""
    with torch.no_grad():
        proj = project_gaussians_cols(means3d, scales, quats, camera)
    return proj.radius > 0
