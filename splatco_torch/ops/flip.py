"""NVIDIA LDR-/HDR-FLIP perceptual error metric (counterpart of
splatco_tpu/ops/flip.py).

The published FLIP algorithm (Andersson et al., HPG 2020 / EG 2021) with
the constants and pipeline of the reference evaluation harness: sRGB ->
YCxCz -> per-channel CSF spatial filtering -> Hunt-adjusted L*a*b* ->
HyAB -> error redistribution, combined with an edge/point feature
difference on the achromatic channel.  The filters are built in numpy
(float64, stored as float32) and applied as replicate-padded float32
convolutions; everything runs on the inputs' device.

Images are [3, H, W] float32 tensors in [0, 1] (LDR) or nonnegative
linear RGB (HDR).  On the card the convolutions must run in full float32:
`utils/device.resolve_device` turns cuDNN's TF32 off.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_PPD = (0.7 * 3840 / 0.7) * math.pi / 180  # 4K @ 0.7m: ~67 px/deg

_REF_ILLUM = np.array([0.950428545, 1.0, 1.088900371], np.float32)
_INV_ILLUM = np.array([1.052156925, 1.0, 0.918357670], np.float32)
_LINRGB2XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
], np.float32)
_XYZ2LINRGB = np.linalg.inv(_LINRGB2XYZ).astype(np.float32)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=torch.float32, device=like.device)


def _per_channel(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return _const(arr, like)[:, None, None]


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    limit = 0.04045
    return torch.where(c > limit,
                       ((torch.clamp_min(c, limit) + 0.055) / 1.055) ** 2.4,
                       c / 12.92)


def linrgb_to_xyz(img: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,jhw->ihw", _const(_LINRGB2XYZ, img), img)


def xyz_to_linrgb(img: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,jhw->ihw", _const(_XYZ2LINRGB, img), img)


def xyz_to_ycxcz(img: torch.Tensor) -> torch.Tensor:
    img = img * _per_channel(_INV_ILLUM, img)
    y = 116.0 * img[1] - 16.0
    cx = 500.0 * (img[0] - img[1])
    cz = 200.0 * (img[1] - img[2])
    return torch.stack([y, cx, cz])


def ycxcz_to_xyz(img: torch.Tensor) -> torch.Tensor:
    y = (img[0] + 16.0) / 116.0
    x = y + img[1] / 500.0
    z = y - img[2] / 200.0
    return torch.stack([x, y, z]) * _per_channel(_REF_ILLUM, img)


def xyz_to_lab(img: torch.Tensor) -> torch.Tensor:
    img = img * _per_channel(_INV_ILLUM, img)
    delta = 6.0 / 29.0
    d3 = delta**3
    f = torch.where(img > d3,
                    torch.clamp_min(img, d3) ** (1.0 / 3.0),
                    img / (3 * delta * delta) + 4.0 / 29.0)
    l = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    return torch.stack([l, a, b])


def srgb_to_ycxcz(img: torch.Tensor) -> torch.Tensor:
    return xyz_to_ycxcz(linrgb_to_xyz(srgb_to_linear(img)))


def hunt_adjust(lab: torch.Tensor) -> torch.Tensor:
    l = lab[0]
    return torch.stack([l, 0.01 * l * lab[1], 0.01 * l * lab[2]])


def hyab(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    d = a - b
    return (torch.sqrt(torch.clamp_min(d[0] * d[0], eps))
            + torch.sqrt(d[1] * d[1] + d[2] * d[2]))


@functools.lru_cache(maxsize=4)
def _csf_filters(ppd: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      int]:
    """Per-channel CSF kernels (A, RG, BY) and the shared radius."""
    coeffs = {
        "A": (1.0, 0.0047, 0.0, 1e-5),
        "RG": (1.0, 0.0053, 0.0, 1e-5),
        "BY": (34.1, 0.04, 13.5, 0.025),
    }
    max_b = 0.04
    r = int(np.ceil(3 * np.sqrt(max_b / (2 * np.pi**2)) * ppd))
    dx = 1.0 / ppd
    x, y = np.meshgrid(range(-r, r + 1), range(-r, r + 1))
    z = (x * dx) ** 2 + (y * dx) ** 2
    out = []
    for ch in ("A", "RG", "BY"):
        a1, b1, a2, b2 = coeffs[ch]
        g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi**2 * z / b1)
             + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi**2 * z / b2))
        out.append((g / g.sum()).astype(np.float32))
    return out[0], out[1], out[2], r


def _conv2d_replicate(img_hw: torch.Tensor, kernel: np.ndarray,
                      radius: int) -> torch.Tensor:
    """Single-channel float32 2D correlation with replicate padding;
    img [H, W] -> [H, W]."""
    pad = F.pad(img_hw[None, None], (radius,) * 4, mode="replicate")
    return F.conv2d(pad, _const(kernel, img_hw)[None, None])[0, 0]


def _spatial_filter(img: torch.Tensor, ppd: float) -> torch.Tensor:
    s_a, s_rg, s_by, r = _csf_filters(ppd)
    filtered = torch.stack([
        _conv2d_replicate(img[0], s_a, r),
        _conv2d_replicate(img[1], s_rg, r),
        _conv2d_replicate(img[2], s_by, r),
    ])
    return torch.clamp(xyz_to_linrgb(ycxcz_to_xyz(filtered)), 0.0, 1.0)


@functools.lru_cache(maxsize=8)
def _feature_kernel(ppd: float, feature: str) -> Tuple[np.ndarray, int]:
    w = 0.082
    sd = 0.5 * w * ppd
    radius = int(np.ceil(3 * sd))
    x, y = np.meshgrid(range(-radius, radius + 1),
                       range(-radius, radius + 1))
    g = np.exp(-(x**2 + y**2) / (2 * sd * sd))
    if feature == "edge":
        gx = -x * g
    else:
        gx = (x**2 / (sd * sd) - 1) * g
    neg = -gx[gx < 0].sum()
    pos = gx[gx > 0].sum()
    gx = np.where(gx < 0, gx / neg, gx / pos).astype(np.float32)
    return gx, radius


def _feature_mag(img_y: torch.Tensor, ppd: float,
                 feature: str) -> torch.Tensor:
    gx, radius = _feature_kernel(ppd, feature)
    fx = _conv2d_replicate(img_y, gx, radius)
    fy = _conv2d_replicate(img_y, np.ascontiguousarray(gx.T), radius)
    return torch.sqrt(fx * fx + fy * fy)


@functools.lru_cache(maxsize=4)
def _cmax(qc: float, eps: float) -> float:
    """HyAB distance of green to blue raised to qc, in float32 on the
    CPU."""
    green = torch.zeros((3, 1, 1), dtype=torch.float32)
    green[1] = 1.0
    blue = torch.zeros((3, 1, 1), dtype=torch.float32)
    blue[2] = 1.0
    hg = hunt_adjust(xyz_to_lab(linrgb_to_xyz(green)))
    hb = hunt_adjust(xyz_to_lab(linrgb_to_xyz(blue)))
    return float(hyab(hg, hb, eps)[0, 0] ** qc)


def ldr_flip_error_map(test: torch.Tensor, reference: torch.Tensor,
                       ppd: float = DEFAULT_PPD, qc: float = 0.7,
                       qf: float = 0.5, pc: float = 0.4, pt: float = 0.95,
                       eps: float = 1e-15) -> torch.Tensor:
    """Per-pixel LDR-FLIP error [H, W]; inputs sRGB [3,H,W] in [0,1]."""
    test = torch.clamp(test, 0.0, 1.0)
    reference = torch.clamp(reference, 0.0, 1.0)
    return _flip_from_ycxcz(srgb_to_ycxcz(test), srgb_to_ycxcz(reference),
                            ppd, qc, qf, pc, pt, eps)


def _flip_from_ycxcz(t_op, r_op, ppd, qc, qf, pc, pt, eps):
    """FLIP core on YCxCz inputs, shared by the LDR entry (after the sRGB
    decode) and the HDR per-exposure loop (after tone mapping)."""
    # colour pipeline
    t_f = hunt_adjust(xyz_to_lab(linrgb_to_xyz(_spatial_filter(t_op, ppd))))
    r_f = hunt_adjust(xyz_to_lab(linrgb_to_xyz(_spatial_filter(r_op, ppd))))
    de_hyab = hyab(r_f, t_f, eps) ** qc
    cmax = _cmax(qc, eps)
    pccmax = pc * cmax
    de_c = torch.where(
        de_hyab < pccmax,
        (pt / pccmax) * de_hyab,
        pt + ((de_hyab - pccmax) / (cmax - pccmax)) * (1.0 - pt))

    # feature pipeline
    r_y = (r_op[0] + 16.0) / 116.0
    t_y = (t_op[0] + 16.0) / 116.0
    de_f = torch.maximum(
        torch.abs(_feature_mag(r_y, ppd, "edge")
                  - _feature_mag(t_y, ppd, "edge")),
        torch.abs(_feature_mag(t_y, ppd, "point")
                  - _feature_mag(r_y, ppd, "point")))
    de_f = ((1.0 / np.sqrt(2.0)) * torch.clamp_min(de_f, eps)) ** qf

    return de_c ** (1.0 - de_f)


def ldr_flip(test: torch.Tensor, reference: torch.Tensor,
             ppd: float = DEFAULT_PPD) -> torch.Tensor:
    """Mean LDR-FLIP error (the reference's LDRFLIPLoss().forward mean)."""
    return ldr_flip_error_map(test, reference, ppd).mean()


# ----------------------------------------------------------------------
# HDR-FLIP
# ----------------------------------------------------------------------

def _tonemap_coeffs(tone_mapper: str):
    """Rational-polynomial coefficients (k0..k5) of the hable and aces
    tone mappers; Reinhard divides by the luminance instead."""
    if tone_mapper == "hable":
        a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0 = a * f - a * e
        k1 = c * b * f - b * e
        k2 = 0.0
        k3 = a * f
        k4 = b * f
        k5 = d * f * f
        w = 11.2
        white_scale = (k3 * w * w + k4 * w + k5) / (k0 * w * w + k1 * w + k2)
        return (4 * k0 * white_scale, 2 * k1 * white_scale, k2 * white_scale,
                4 * k3, 2 * k4, k5)
    # ACES approximation with pre-exposure cancellation
    return (0.6 * 0.6 * 2.51, 0.6 * 0.03, 0.0,
            0.6 * 0.6 * 2.43, 0.6 * 0.59, 0.14)


def tone_map(img: torch.Tensor, tone_mapper: str,
             exposure: float) -> torch.Tensor:
    """Exposure compensation + tone mapping -> LDR linear RGB in [0,1]."""
    x = (2.0 ** exposure) * img
    if tone_mapper == "reinhard":
        y_lum = (0.2126 * x[0] + 0.7152 * x[1] + 0.0722 * x[2])
        return torch.clamp(x / (1.0 + y_lum)[None], 0.0, 1.0)
    k0, k1, k2, k3, k4, k5 = _tonemap_coeffs(tone_mapper)
    x2 = x * x
    nom = k0 * x2 + k1 * x + k2
    denom = k3 * x2 + k4 * x + k5
    denom = torch.where(torch.isinf(denom), 1.0, denom)
    return torch.clamp(nom / denom, 0.0, 1.0)


def _inverse_tonemap_x(tone_mapper: str, t: float) -> float:
    """Solve tone_map(x) = t for x (the exposure range's endpoints)."""
    if tone_mapper == "reinhard":
        return t * 1.0 / (1.0 - t * 1.0)
    k0, k1, k2, k3, k4, k5 = _tonemap_coeffs(tone_mapper)
    c0 = (k1 - k4 * t) / (k0 - k3 * t)
    c1 = (k2 - k5 * t) / (k0 - k3 * t)
    return float(-0.5 * c0 + np.sqrt((0.5 * c0) ** 2 - c1))


def compute_start_stop_exposures(reference: torch.Tensor,
                                 tone_mapper: str = "aces",
                                 tmax: float = 0.85, tmin: float = 0.85):
    """Start/stop exposures from the reference image's luminance range,
    as host floats (HDR-FLIP is an offline metric).  The median is the
    lower middle element, as torch.median takes it, not numpy's average
    of the two middle ones."""
    x_max = _inverse_tonemap_x(tone_mapper, tmax)
    x_min = _inverse_tonemap_x(tone_mapper, tmin)
    ref = reference.detach().cpu().numpy()
    y_ref = 0.2126 * ref[0] + 0.7152 * ref[1] + 0.0722 * ref[2]
    y_hi = float(y_ref.max())
    flat = np.sort(y_ref.reshape(-1))
    y_lo = float(flat[(flat.size - 1) // 2])
    start_exposure = math.log2(x_max / max(y_hi, 1e-30))
    stop_exposure = math.log2(x_min / max(y_lo, 1e-30))
    return start_exposure, stop_exposure


def hdr_flip_error_map(test: torch.Tensor, reference: torch.Tensor,
                       ppd: float = DEFAULT_PPD, tone_mapper: str = "aces",
                       start_exposure: float = None,
                       stop_exposure: float = None, qc: float = 0.7,
                       qf: float = 0.5, pc: float = 0.4, pt: float = 0.95,
                       eps: float = 1e-15) -> torch.Tensor:
    """Per-pixel HDR-FLIP error [H, W]; inputs nonnegative linear RGB
    [3,H,W].  Tone-maps both at a sweep of exposures, runs the FLIP core
    on each LDR pair and keeps the per-pixel maximum."""
    test = torch.clamp(test, 0.0, 65536.0)
    reference = torch.clamp(reference, 0.0, 65536.0)
    if start_exposure is None or stop_exposure is None:
        c_start, c_stop = compute_start_stop_exposures(reference,
                                                       tone_mapper)
        start_exposure = c_start if start_exposure is None else start_exposure
        stop_exposure = c_stop if stop_exposure is None else stop_exposure
    num_exposures = max(2, int(math.ceil(stop_exposure - start_exposure)))
    step = (stop_exposure - start_exposure) / max(num_exposures - 1, 1)
    err = None
    for i in range(num_exposures):
        exposure = start_exposure + i * step
        r_op = xyz_to_ycxcz(linrgb_to_xyz(
            tone_map(reference, tone_mapper, exposure)))
        t_op = xyz_to_ycxcz(linrgb_to_xyz(
            tone_map(test, tone_mapper, exposure)))
        e = _flip_from_ycxcz(t_op, r_op, ppd, qc, qf, pc, pt, eps)
        err = e if err is None else torch.maximum(err, e)
    return err


def hdr_flip(test: torch.Tensor, reference: torch.Tensor,
             ppd: float = DEFAULT_PPD,
             tone_mapper: str = "aces") -> torch.Tensor:
    """Mean HDR-FLIP error (the reference's HDRFLIPLoss().forward mean)."""
    return hdr_flip_error_map(test, reference, ppd, tone_mapper).mean()
