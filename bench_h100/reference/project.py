"""The reference's EWA projection (the 3DGS preprocess) in columns: the
covariance R diag(s^2) R^T from scale and quaternion, the Jacobian at the
frustum-clamped point, the 0.3 px low-pass, the conic, the 3-sigma radius
and the near / screen cull.  Differentiable by autograd."""
from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_CLIP = 0.2
LOWPASS = 0.3


class Cols(NamedTuple):
    mx: torch.Tensor
    my: torch.Tensor
    depth: torch.Tensor
    ca: torch.Tensor
    cb: torch.Tensor
    cc: torch.Tensor
    radius: torch.Tensor  # float32, 0: culled


def covariance(scales: torch.Tensor, quats: torch.Tensor):
    """Six columns (xx, xy, xz, yy, yz, zz) of R diag(s^2) R^T."""
    n = torch.clamp_min(torch.sqrt(quats[:, 0] ** 2 + quats[:, 1] ** 2
                                   + quats[:, 2] ** 2 + quats[:, 3] ** 2),
                        1e-12)
    w, x, y, z = (quats[:, i] / n for i in range(4))
    r = ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
         (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
         (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))
    v = tuple(scales[:, k] * scales[:, k] for k in range(3))

    def sig(a, b):
        return (v[0] * r[a][0] * r[b][0] + v[1] * r[a][1] * r[b][1]
                + v[2] * r[a][2] * r[b][2])

    return (sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2))


def project(means: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
            cam) -> Cols:
    """Screen-space columns of gaussians [N] seen by `cam`
    (model.RefCamera)."""
    vm, pm = cam.view, cam.full
    w_px, h_px = cam.width, cam.height
    fx = w_px / (2.0 * cam.tan_fovx)
    fy = h_px / (2.0 * cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    px, py, pz = means[:, 0], means[:, 1], means[:, 2]

    def xform(m, col):
        return px * m[0, col] + py * m[1, col] + pz * m[2, col] + m[3, col]

    tx_v, ty_v, tz = xform(vm, 0), xform(vm, 1), xform(vm, 2)
    in_front = tz > NEAR_CLIP
    p_w = 1.0 / (xform(pm, 3) + 1e-7)
    safe_z = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    tx = torch.clamp(tx_v / safe_z, -limx, limx) * tz
    ty = torch.clamp(ty_v / safe_z, -limy, limy) * tz
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    a0, a2 = fx * inv_z, -fx * tx * inv_z2
    b1, b2 = fy * inv_z, -fy * ty * inv_z2
    m0 = tuple(a0 * vm[k, 0] + a2 * vm[k, 2] for k in range(3))
    m1 = tuple(b1 * vm[k, 1] + b2 * vm[k, 2] for k in range(3))
    xx, xy, xz, yy, yz, zz = covariance(scales, quats)

    def quad(u, w):
        return (u[0] * (xx * w[0] + xy * w[1] + xz * w[2])
                + u[1] * (xy * w[0] + yy * w[1] + yz * w[2])
                + u[2] * (xz * w[0] + yz * w[1] + zz * w[2]))

    c00 = quad(m0, m0) + LOWPASS
    c01 = quad(m0, m1)
    c11 = quad(m1, m1) + LOWPASS
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    rad = torch.ceil(3.0 * torch.sqrt(lam))
    mx = ((xform(pm, 0) * p_w + 1.0) * w_px - 1.0) * 0.5
    my = ((xform(pm, 1) * p_w + 1.0) * h_px - 1.0) * 0.5
    on_screen = ((mx + rad > 0) & (mx - rad < w_px) & (my + rad > 0)
                 & (my - rad < h_px))
    radius = torch.where(in_front & det_ok & on_screen, rad, 0.0)
    return Cols(mx, my, tz, c11 * inv_det, -c01 * inv_det, c00 * inv_det,
                radius)


def visible(anchors, active: torch.Tensor, cam) -> torch.Tensor:
    """The anchor prefilter: anchors whose own projection (base scales,
    columns 0-2, and the anchor rotation) has a radius, and active."""
    q = anchors["rotation"]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                            1e-12)
    with torch.no_grad():
        cols = project(anchors["anchor"], torch.exp(anchors["scaling"])[:, :3],
                       q, cam)
    return (cols.radius > 0) & active
