"""EWA projection stage of the Gaussian rasterizer (counterpart of
splatco_tpu/ops/projection.py).  The columnwise path (`project_cols`,
`ProjectedCols`) is the one `render` runs; the AoS path (`project`,
`ProjectedGaussians`) is the same math on [N, 3, 3] matrices, the public
API the tools and the JAX package's callers use.

  * row-vector convention: p_hom = [p,1] @ full_proj (matrices stored
    transposed, see data/cameras.py),
  * near-plane cull at p_view.z <= 0.2,
  * EWA: cov2D = (J W Sigma W^T J^T)[:2,:2] with the +-1.3*tan(fov)
    frustum clamp on t.x/t.z, t.y/t.z before building J,
  * low-pass dilation cov2D += 0.3 * I,
  * radius = ceil(3 * sqrt(lambda_max)), lambda_max = mid + sqrt(max(0.1,
    mid^2 - det)), and an on-screen test of the radius square,
  * ndc2Pix(v, S) = ((v + 1) * S - 1) / 2.

`project_gaussians` (and `project_gaussians_cols`, which takes a camera)
is the main path's entry point: `_Project`, whose forward is
`project_fwd` (the covariance and the whole EWA preprocess, written as
one [7, N] buffer whose rows are the returned columns) and whose
backward is `project_bwd`, the hand-written VJP, which recomputes the
forward's values from the inputs it keeps.  `visible_radius_mask` (and
`visible_filter`) is the prefilter's: `project_fwd(radius_only=True) >
0`.  For CUDA tensors the two wrappers launch `csrc/project_fwd.cu` and
`csrc/project_bwd.cu` (the arithmetic of both in `csrc/project.cuh`;
each call adds one to `cuda_lib.LAUNCHES`); for CPU tensors they run the
plain versions (`covariance_cols` + `project_cols`, `_project_bwd_plain`);
any other device raises, and there is no fallback from one to the other.
The kernels are built with --fmad=false and repeat their plain versions'
float32 operations in order, so on the card the two agree bit for bit.
Forward and backward run inside `torch.profiler.record_function(
"projection")` ranges.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from splatco_torch.ops import cuda_lib

NEAR_CLIP = 0.2
LOWPASS = 0.3
FWD_KERNEL = "project_fwd"
BWD_KERNEL = "project_bwd"
KERNELS = (FWD_KERNEL, BWD_KERNEL)


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (all [N, ...]), AoS."""
    means2d: torch.Tensor   # [N,2] pixel coords
    depths: torch.Tensor    # [N] view-space z
    conics: torch.Tensor    # [N,3] upper triangle of inverse cov2d (a, b, c)
    radii: torch.Tensor     # [N] int32, 0 => culled
    p_view_z: torch.Tensor  # [N] raw view z (before the near cull)


class ProjectedCols(NamedTuple):
    """SoA screen-space quantities: seven [N] float32 columns."""
    mx: torch.Tensor      # pixel x
    my: torch.Tensor      # pixel y
    depth: torch.Tensor   # view z
    ca: torch.Tensor      # conic a
    cb: torch.Tensor      # conic b
    cc: torch.Tensor      # conic c
    radius: torch.Tensor  # float32, 0 => culled


def cols_of(proj: ProjectedGaussians) -> ProjectedCols:
    return ProjectedCols(
        mx=proj.means2d[:, 0], my=proj.means2d[:, 1], depth=proj.depths,
        ca=proj.conics[:, 0], cb=proj.conics[:, 1], cc=proj.conics[:, 2],
        radius=proj.radii.to(torch.float32))


def aos_of(cols: ProjectedCols) -> ProjectedGaussians:
    return ProjectedGaussians(
        means2d=torch.stack([cols.mx, cols.my], dim=1),
        depths=cols.depth,
        conics=torch.stack([cols.ca, cols.cb, cols.cc], dim=1),
        radii=cols.radius.to(torch.int32),
        p_view_z=cols.depth)


def project(means3d: torch.Tensor, cov3d: torch.Tensor,
            viewmatrix: torch.Tensor, projmatrix: torch.Tensor,
            image_width: int, image_height: int, tan_fovx: float,
            tan_fovy: float) -> ProjectedGaussians:
    """EWA-project gaussians with world positions [N, 3] and world-space
    covariances [N, 3, 3] (`build_covariance`); the matrices [4, 4] are
    transposed world->view and full projection."""
    n = means3d.shape[0]
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)
    hom = torch.cat([means3d, means3d.new_ones((n, 1))], dim=-1)

    p_view = hom @ viewmatrix  # [N,4]
    tz = p_view[:, 2]
    in_front = tz > NEAR_CLIP
    p_hom = hom @ projmatrix
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    # EWA with the frustum clamp on the point the Jacobian is taken at
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    safe_z = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    tx = torch.clamp(p_view[:, 0] / safe_z, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / safe_z, -limy, limy) * tz
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([focal_x * inv_z, zeros, -focal_x * tx * inv_z2], -1),
        torch.stack([zeros, focal_y * inv_z, -focal_y * ty * inv_z2], -1),
        torch.stack([zeros, zeros, zeros], -1)], dim=-2)  # [N,3,3]
    W = viewmatrix[:3, :3].T  # world->cam rotation
    T = J @ W[None]
    cov2d = (T @ cov3d @ T.transpose(-1, -2))[:, :2, :2]
    cov00 = cov2d[:, 0, 0] + LOWPASS
    cov01 = cov2d[:, 0, 1]
    cov11 = cov2d[:, 1, 1] + LOWPASS

    det = cov00 * cov11 - cov01 * cov01
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([cov11 * inv_det, -cov01 * inv_det,
                          cov00 * inv_det], dim=-1)
    mid = 0.5 * (cov00 + cov11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    means2d = torch.stack(
        [((p_proj[:, 0] + 1.0) * image_width - 1.0) * 0.5,
         ((p_proj[:, 1] + 1.0) * image_height - 1.0) * 0.5], dim=-1)
    on_screen = ((means2d[:, 0] + radius_f > 0)
                 & (means2d[:, 0] - radius_f < image_width)
                 & (means2d[:, 1] + radius_f > 0)
                 & (means2d[:, 1] - radius_f < image_height))
    visible = in_front & det_ok & on_screen
    radii = torch.where(visible, radius_f, 0.0).to(torch.int32)
    return ProjectedGaussians(means2d=means2d, depths=tz, conics=conics,
                              radii=radii, p_view_z=tz)


def project_from_camera(means3d, cov3d, camera) -> ProjectedGaussians:
    return project(means3d, cov3d, camera.world_view_transform,
                   camera.full_proj_transform, camera.image_width,
                   camera.image_height, camera.tan_fovx, camera.tan_fovy)


def _rotation(quats: torch.Tensor):
    """(|q|, clamp_min(|q|, 1e-12), the normalised (w, x, y, z), R's rows)
    of quaternions [N, 4]."""
    n_raw = torch.sqrt(quats[:, 0] ** 2 + quats[:, 1] ** 2
                       + quats[:, 2] ** 2 + quats[:, 3] ** 2)
    n = torch.clamp_min(n_raw, 1e-12)
    w, x, y, z = (quats[:, i] / n for i in range(4))
    r = ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
         (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
         (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))
    return n_raw, n, (w, x, y, z), r


def _sigma(scales: torch.Tensor, r):
    """(s^2 columns, Sigma = R diag(s^2) R^T's six columns (xx, xy, xz,
    yy, yz, zz)) for R's rows `r`."""
    v = tuple(scales[:, k] * scales[:, k] for k in range(3))

    def sig(a, b):
        return (v[0] * r[a][0] * r[b][0] + v[1] * r[a][1] * r[b][1]
                + v[2] * r[a][2] * r[b][2])

    return v, (sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2),
               sig(2, 2))


def covariance_cols(scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = R diag(s^2) R^T as 6 columns (xx, xy, xz, yy, yz, zz)."""
    return _sigma(scales, _rotation(quats)[3])[1]


def _camera_scalars(image_width, image_height, tan_fovx: float,
                    tan_fovy: float):
    """(focal_x, focal_y, limx, limy) as Python floats: torch rounds each
    to float32 where it meets a float32 tensor, and so do the kernels'
    wrappers."""
    return (image_width / (2.0 * tan_fovx), image_height / (2.0 * tan_fovy),
            1.3 * tan_fovx, 1.3 * tan_fovy)


def _ewa_terms(means3d: torch.Tensor, cov6, viewmatrix: torch.Tensor,
               projmatrix: torch.Tensor, image_width, image_height,
               tan_fovx: float, tan_fovy: float) -> SimpleNamespace:
    """`project_cols`' columns: its outputs and every value the VJP
    reads (the kernels' `project::Terms`, csrc/project.cuh)."""
    px_, py_, pz_ = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    focal_x, focal_y, limx, limy = _camera_scalars(
        image_width, image_height, tan_fovx, tan_fovy)
    vm = viewmatrix
    pm = projmatrix

    def xform(m, col):
        return (px_ * m[0, col] + py_ * m[1, col] + pz_ * m[2, col]
                + m[3, col])

    t = SimpleNamespace(cov6=cov6)
    tx_v = xform(vm, 0)
    ty_v = xform(vm, 1)
    t.tz = tz = xform(vm, 2)
    in_front = tz > NEAR_CLIP

    t.hx = xform(pm, 0)
    t.hy = xform(pm, 1)
    hw = xform(pm, 3)
    t.p_w = 1.0 / (hw + 1e-7)

    t.safe_z = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    t.qx = tx_v / t.safe_z
    t.qy = ty_v / t.safe_z
    t.cx = torch.clamp(t.qx, -limx, limx)
    t.cy = torch.clamp(t.qy, -limy, limy)
    t.tx = t.cx * tz
    t.ty = t.cy * tz
    t.inv_z = 1.0 / t.safe_z
    t.inv_z2 = t.inv_z * t.inv_z

    # M = J @ W rows (W = world->cam rotation = viewmatrix[:3,:3]^T)
    a0 = focal_x * t.inv_z
    a2 = -focal_x * t.tx * t.inv_z2
    b1 = focal_y * t.inv_z
    b2 = -focal_y * t.ty * t.inv_z2
    t.m0 = tuple(a0 * vm[k, 0] + a2 * vm[k, 2] for k in range(3))
    t.m1 = tuple(b1 * vm[k, 1] + b2 * vm[k, 2] for k in range(3))

    xx, xy, xz, yy, yz, zz = cov6

    def quad(u, w):
        return (u[0] * (xx * w[0] + xy * w[1] + xz * w[2])
                + u[1] * (xy * w[0] + yy * w[1] + yz * w[2])
                + u[2] * (xz * w[0] + yz * w[1] + zz * w[2]))

    t.cov00 = cov00 = quad(t.m0, t.m0) + LOWPASS
    t.cov01 = cov01 = quad(t.m0, t.m1)
    t.cov11 = cov11 = quad(t.m1, t.m1) + LOWPASS

    t.det = det = cov00 * cov11 - cov01 * cov01
    t.det_ok = det_ok = det != 0.0
    t.inv_det = inv_det = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    t.conic = (cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det)

    mid = 0.5 * (cov00 + cov11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    t.mx = mx = ((t.hx * t.p_w + 1.0) * image_width - 1.0) * 0.5
    t.my = my = ((t.hy * t.p_w + 1.0) * image_height - 1.0) * 0.5
    on_screen = ((mx + radius_f > 0) & (mx - radius_f < image_width)
                 & (my + radius_f > 0) & (my - radius_f < image_height))
    visible = in_front & det_ok & on_screen
    t.radius = torch.where(visible, radius_f, 0.0)
    return t


def project_cols(means3d: torch.Tensor, cov6, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor, image_width: int,
                 image_height: int, tan_fovx: float, tan_fovy: float
                 ) -> ProjectedCols:
    """Columnwise EWA projection of [N] gaussians; `cov6` from
    covariance_cols."""
    t = _ewa_terms(means3d, cov6, viewmatrix, projmatrix, image_width,
                   image_height, tan_fovx, tan_fovy)
    return ProjectedCols(t.mx, t.my, t.tz, *t.conic, t.radius)


def _project_fwd_plain(means3d, scales, quats, viewmatrix, projmatrix,
                       image_width, image_height, tan_fovx, tan_fovy,
                       radius_only: bool = False) -> torch.Tensor:
    """`covariance_cols` then `project_cols`, as the kernel writes them:
    [7, N] (mx, my, depth, conic a, b, c, radius), or the radius [N]."""
    proj = project_cols(means3d, covariance_cols(scales, quats), viewmatrix,
                        projmatrix, image_width, image_height, tan_fovx,
                        tan_fovy)
    return proj.radius if radius_only else torch.stack(proj)


def _project_bwd_plain(cots, means3d, scales, quats, viewmatrix,
                       projmatrix, image_width, image_height, tan_fovx,
                       tan_fovy):
    """The projection's VJP, written by hand: (d_means [N, 3], d_scales
    [N, 3], d_quats [N, 4]) for the cotangents `cots` of (mx, my, depth,
    conic a, b, c), each [N] or None for zeros.  It recomputes the
    forward's values from the inputs and follows autograd's rules for the
    formula: zero through the branch a `where` does not take, `clamp`'s
    gradient inside the closed interval, `clamp_min`'s where x >= min,
    nothing through `ceil` (the radius has no gradient)."""
    n_raw, n, (w, x, y, z), r = _rotation(quats)
    v, cov6 = _sigma(scales, r)
    t = _ewa_terms(means3d, cov6, viewmatrix, projmatrix, image_width,
                   image_height, tan_fovx, tan_fovy)
    fx, fy, limx, limy = _camera_scalars(image_width, image_height,
                                         tan_fovx, tan_fovy)
    vm, pm = viewmatrix, projmatrix
    zeros = torch.zeros_like(t.tz)
    g_mx, g_my, g_depth, g_ca, g_cb, g_cc = (
        zeros if g is None else g for g in cots)

    # the pixel means -> hx, hy, p_w -> hw
    gu = (g_mx * 0.5) * image_width
    gv = (g_my * 0.5) * image_height
    g_hx = gu * t.p_w
    g_hy = gv * t.p_w
    g_pw = gu * t.hx + gv * t.hy
    g_hw = -g_pw * (t.p_w * t.p_w)

    # the conic -> cov2D
    g_inv_det = (g_ca * t.cov11 + g_cb * -t.cov01) + g_cc * t.cov00
    g_det = torch.where(t.det_ok, -g_inv_det * (t.inv_det * t.inv_det), 0.0)
    gd01 = g_det * t.cov01
    g00 = g_cc * t.inv_det + g_det * t.cov11
    g11 = g_ca * t.inv_det + g_det * t.cov00
    g01 = -(g_cb * t.inv_det) - (gd01 + gd01)

    # cov2D = M Sigma M^T -> M's rows and Sigma's six columns
    xx, xy, xz, yy, yz, zz = cov6
    m0, m1 = t.m0, t.m1

    def times_sigma(u):
        return ((xx * u[0] + xy * u[1]) + xz * u[2],
                (xy * u[0] + yy * u[1]) + yz * u[2],
                (xz * u[0] + yz * u[1]) + zz * u[2])

    sa, sb = times_sigma(m0), times_sigma(m1)
    t00, t11 = g00 + g00, g11 + g11
    g_m0 = [t00 * sa[k] + g01 * sb[k] for k in range(3)]
    g_m1 = [g01 * sa[k] + t11 * sb[k] for k in range(3)]
    e = [g00 * m0[k] + g01 * m1[k] for k in range(3)]
    f = [g11 * m1[k] for k in range(3)]
    tt = [[m0[i] * e[j] + m1[i] * f[j] for j in range(3)] for i in range(3)]
    g_xx, g_yy, g_zz = tt[0][0], tt[1][1], tt[2][2]
    g_xy = tt[0][1] + tt[1][0]
    g_xz = tt[0][2] + tt[2][0]
    g_yz = tt[1][2] + tt[2][1]

    # M's rows -> a0, a2, b1, b2 -> tx, ty, inv_z
    def dot_col(g, col):
        return (g[0] * vm[0, col] + g[1] * vm[1, col]) + g[2] * vm[2, col]

    g_a0, g_a2 = dot_col(g_m0, 0), dot_col(g_m0, 2)
    g_b1, g_b2 = dot_col(g_m1, 1), dot_col(g_m1, 2)
    g_tx = (g_a2 * t.inv_z2) * -fx
    g_ty = (g_b2 * t.inv_z2) * -fy
    g_inv_z2 = g_a2 * (-fx * t.tx) + g_b2 * (-fy * t.ty)
    g_inv_z = ((g_a0 * fx + g_b1 * fy)
               + (g_inv_z2 * t.inv_z + g_inv_z2 * t.inv_z))

    # the clamp -> the view coordinates and safe_z
    g_qx = torch.where((t.qx >= -limx) & (t.qx <= limx), g_tx * t.tz, 0.0)
    g_qy = torch.where((t.qy >= -limy) & (t.qy <= limy), g_ty * t.tz, 0.0)
    g_txv = g_qx / t.safe_z
    g_tyv = g_qy / t.safe_z
    g_safe_z = ((-g_inv_z * (t.inv_z * t.inv_z)
                 + -g_qx * (t.qx / t.safe_z)) + -g_qy * (t.qy / t.safe_z))
    g_tz = (((g_depth + g_tx * t.cx) + g_ty * t.cy)
            + torch.where(torch.abs(t.tz) < 1e-8, 0.0, g_safe_z))

    # the view and clip coordinates -> the mean
    d_means = torch.stack([
        ((((g_txv * vm[k, 0] + g_tyv * vm[k, 1]) + g_tz * vm[k, 2])
          + g_hx * pm[k, 0]) + g_hy * pm[k, 1]) + g_hw * pm[k, 3]
        for k in range(3)], dim=1)

    # Sigma's columns -> v = s^2 and R
    dxx, dyy, dzz = g_xx + g_xx, g_yy + g_yy, g_zz + g_zz
    d_scales, g_r = [], [[None] * 3 for _ in range(3)]
    for k in range(3):
        c0, c1, c2 = r[0][k], r[1][k], r[2][k]
        g_v = (((((g_xx * (c0 * c0) + g_xy * (c0 * c1)) + g_xz * (c0 * c2))
                 + g_yy * (c1 * c1)) + g_yz * (c1 * c2)) + g_zz * (c2 * c2))
        d_scales.append(g_v * scales[:, k] + g_v * scales[:, k])
        g_r[0][k] = v[k] * ((dxx * c0 + g_xy * c1) + g_xz * c2)
        g_r[1][k] = v[k] * ((g_xy * c0 + dyy * c1) + g_yz * c2)
        g_r[2][k] = v[k] * ((g_xz * c0 + g_yz * c1) + dzz * c2)

    # R -> the normalised quaternion (w, x, y, z)
    s01, s02 = g_r[0][1] + g_r[1][0], g_r[0][2] + g_r[2][0]
    s12 = g_r[1][2] + g_r[2][1]
    d01, d02 = g_r[1][0] - g_r[0][1], g_r[0][2] - g_r[2][0]
    d12 = g_r[2][1] - g_r[1][2]
    g_u = (2 * ((x * d12 + y * d02) + z * d01),
           2 * ((y * s01 + z * s02) + w * d12)
           - 4 * (x * (g_r[1][1] + g_r[2][2])),
           2 * ((x * s01 + z * s12) + w * d02)
           - 4 * (y * (g_r[0][0] + g_r[2][2])),
           2 * ((x * s02 + y * s12) + w * d01)
           - 4 * (z * (g_r[0][0] + g_r[1][1])))

    # the normalisation q / clamp_min(|q|, 1e-12) -> q
    g_n = -(((g_u[0] * w + g_u[1] * x) + g_u[2] * y) + g_u[3] * z) / n
    g_n_raw = torch.where(n_raw >= 1e-12, g_n, 0.0)
    g_sq = g_n_raw / (2 * n_raw)
    d_quats = torch.stack([g_u[i] / n + g_sq * (2 * quats[:, i])
                           for i in range(4)], dim=1)
    return d_means, torch.stack(d_scales, dim=1), d_quats


_P, _L, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)


def _checked(means3d, scales, quats, viewmatrix, projmatrix, kernel: str):
    """The inputs made contiguous, after the checks the kernels need:
    one device (the CPU or a CUDA card), float32 on the card, [N, 3] /
    [N, 3] / [N, 4] rows and [4, 4] matrices."""
    tensors = (means3d, scales, quats, viewmatrix, projmatrix)
    dev = means3d.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    n = means3d.shape[0]
    for t, shape in zip(tensors, ((n, 3), (n, 3), (n, 4), (4, 4), (4, 4))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{kernel} takes means [N, 3], scales [N, 3], "
                             f"quats [N, 4] and [4, 4] matrices on one "
                             f"device, got {[tuple(x.shape) for x in tensors]}"
                             f" on {[str(x.device) for x in tensors]}")
        if dev.type == "cuda" and t.dtype != torch.float32:
            raise ValueError(f"{kernel} takes float32, got {t.dtype}")
    return tuple(t.contiguous() for t in tensors)


def _camera_args(image_width, image_height, tan_fovx, tan_fovy):
    """The kernels' camera scalars: focal_x, focal_y, limx, limy, W, H."""
    return (*_camera_scalars(image_width, image_height, tan_fovx, tan_fovy),
            float(image_width), float(image_height))


def project_fwd(means3d, scales, quats, viewmatrix, projmatrix, image_width,
                image_height, tan_fovx, tan_fovy,
                radius_only: bool = False) -> torch.Tensor:
    """`covariance_cols` then `project_cols` into one [7, N] buffer (mx,
    my, depth, conic a, b, c, radius), or the radius [N] alone with
    `radius_only`: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    means3d, scales, quats, viewmatrix, projmatrix = _checked(
        means3d, scales, quats, viewmatrix, projmatrix, FWD_KERNEL)
    geom = (image_width, image_height, tan_fovx, tan_fovy)
    if means3d.device.type == "cpu":
        return _project_fwd_plain(means3d, scales, quats, viewmatrix,
                                  projmatrix, *geom, radius_only=radius_only)
    n = means3d.shape[0]
    out = torch.empty((n,) if radius_only else (7, n), dtype=torch.float32,
                      device=means3d.device)
    fn = cuda_lib.function(FWD_KERNEL, (_P, _P, _P, _L, _P, _P, _F, _F, _F,
                                        _F, _F, _F, _I, _P, _P))
    with torch.cuda.device(means3d.device):
        err = fn(means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), n,
                 viewmatrix.data_ptr(), projmatrix.data_ptr(),
                 *_camera_args(*geom), int(radius_only), out.data_ptr(),
                 cuda_lib.stream(means3d.device))
    cuda_lib.launched(FWD_KERNEL, err)
    return out


def project_bwd(cots, means3d, scales, quats, viewmatrix, projmatrix,
                image_width, image_height, tan_fovx, tan_fovy):
    """(d_means [N, 3], d_scales [N, 3], d_quats [N, 4]) for the
    cotangents of (mx, my, depth, conic a, b, c), each [N] or None for
    zeros: the kernel for CUDA tensors (made contiguous), the hand VJP
    `_project_bwd_plain` for CPU ones."""
    means3d, scales, quats, viewmatrix, projmatrix = _checked(
        means3d, scales, quats, viewmatrix, projmatrix, BWD_KERNEL)
    n, dev = means3d.shape[0], means3d.device
    if len(cots) != 6 or any(
            g is not None and (tuple(g.shape) != (n,) or g.device != dev
                               or g.dtype != means3d.dtype)
            for g in cots):
        raise ValueError(f"{BWD_KERNEL} takes six cotangents [{n}] "
                         f"{means3d.dtype} on {dev} (or None)")
    geom = (image_width, image_height, tan_fovx, tan_fovy)
    if dev.type == "cpu":
        return _project_bwd_plain(cots, means3d, scales, quats, viewmatrix,
                                  projmatrix, *geom)
    cots = [None if g is None else g.contiguous() for g in cots]
    d_means, d_scales = torch.empty_like(means3d), torch.empty_like(scales)
    d_quats = torch.empty_like(quats)
    fn = cuda_lib.function(BWD_KERNEL, (_P, _P, _P, _L, _P, _P, _F, _F, _F,
                                        _F, _F, _F, *[_P] * 6, _P, _P, _P,
                                        _P))
    with torch.cuda.device(dev):
        err = fn(means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), n,
                 viewmatrix.data_ptr(), projmatrix.data_ptr(),
                 *_camera_args(*geom),
                 *[None if g is None else g.data_ptr() for g in cots],
                 d_means.data_ptr(), d_scales.data_ptr(), d_quats.data_ptr(),
                 cuda_lib.stream(dev))
    cuda_lib.launched(BWD_KERNEL, err)
    return d_means, d_scales, d_quats


class _Project(torch.autograd.Function):
    """`project_fwd` with its hand-written VJP `project_bwd`; it keeps
    only the inputs for the backward.  The radius has no gradient."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, viewmatrix, projmatrix, geom):
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, quats, viewmatrix, projmatrix)
        cols = project_fwd(means3d, scales, quats, viewmatrix, projmatrix,
                           *geom).unbind(0)
        ctx.mark_non_differentiable(cols[6])
        return cols

    @staticmethod
    def backward(ctx, *cots):
        if all(g is None for g in cots[:6]):
            return (None,) * 6
        with torch.profiler.record_function("projection"):
            grads = project_bwd(cots[:6], *ctx.saved_tensors, *ctx.geom)
        return (*grads, None, None, None)


def project_gaussians(means3d, scales, quats, viewmatrix, projmatrix,
                      image_width, image_height, tan_fovx,
                      tan_fovy) -> ProjectedCols:
    """scales/quats -> covariance columns -> columnwise EWA, in one
    kernel launch forward and one backward (`_Project`), inside
    `record_function("projection")` ranges."""
    with torch.profiler.record_function("projection"):
        return ProjectedCols(*_Project.apply(
            means3d, scales, quats, viewmatrix, projmatrix,
            (image_width, image_height, tan_fovx, tan_fovy)))


def project_gaussians_cols(means3d, scales, quats, camera) -> ProjectedCols:
    """`project_gaussians` with the camera's matrices and geometry."""
    return project_gaussians(
        means3d, scales, quats, camera.world_view_transform,
        camera.full_proj_transform, camera.image_width, camera.image_height,
        camera.tan_fovx, camera.tan_fovy)


def visible_radius_mask(means3d, scales, quats, viewmatrix, projmatrix,
                        image_width, image_height, tan_fovx,
                        tan_fovy) -> torch.Tensor:
    """radius > 0 of the projection: bool [N], no gradient (the kernel's
    radius-only launch)."""
    with torch.profiler.record_function("projection"), torch.no_grad():
        return project_fwd(means3d, scales, quats, viewmatrix, projmatrix,
                           image_width, image_height, tan_fovx, tan_fovy,
                           radius_only=True) > 0


def visible_filter(means3d, scales, quats, camera) -> torch.Tensor:
    """Frustum/extent cull without shading (the prefilter).  bool [N]."""
    return visible_radius_mask(
        means3d, scales, quats, camera.world_view_transform,
        camera.full_proj_transform, camera.image_width, camera.image_height,
        camera.tan_fovx, camera.tan_fovy)


def rect_bounds(mx, my, radius, tile_size: int, tiles_x: int, tiles_y: int):
    """(x0, y0, x1, y1) int32 columns of each gaussian's tile rect: the
    tiles its radius square touches, exclusive upper, clamped to the grid
    (CUDA's getRect).  The binning and the dense compositor's tile cull
    both take their rects from here."""
    def span(c, lo_hi, n):
        return torch.clamp(lo_hi(c / tile_size), 0, n).to(torch.int32)

    return (span(mx - radius, torch.floor, tiles_x),
            span(my - radius, torch.floor, tiles_y),
            span(mx + radius, torch.ceil, tiles_x),
            span(my + radius, torch.ceil, tiles_y))


def tile_rect(means2d: torch.Tensor, radii: torch.Tensor, tile_size: int,
              tiles_x: int, tiles_y: int) -> torch.Tensor:
    """Per-gaussian tile rect [N, 4] = (x0, y0, x1, y1), exclusive upper,
    in tiles; an empty rect (x0 >= x1 or y0 >= y1) touches no tile."""
    r = radii.to(means2d.dtype)
    return torch.stack(rect_bounds(means2d[:, 0], means2d[:, 1], r,
                                   tile_size, tiles_x, tiles_y), dim=-1)
