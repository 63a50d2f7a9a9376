"""Photometric losses and image metrics (counterpart of
splatco_tpu/ops/losses.py).

l1 / ssim follow the reference (11x11 Gaussian window, sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2, zero-padded SAME depthwise filter); psnr is per
leading dim, so a [3,H,W] image yields per-channel PSNR.  All functions
take channel-first images [C,H,W] (or [B,C,H,W] for ssim) in [0,1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    flat = (img1 - img2).reshape(img1.shape[0], -1)
    return (flat ** 2).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-leading-dim PSNR ([3,H,W] -> per channel)."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def psnr_scalar(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Whole-image PSNR (one scalar over all pixels and channels)."""
    m = ((img1 - img2) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    gauss = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma**2)
    )
    return (gauss / gauss.sum()).astype(np.float32)


def _sep_gauss_blur(img: torch.Tensor, g1d) -> torch.Tensor:
    """Zero-padded SAME Gaussian blur of img [B,C,H,W] as two separable
    shift-add passes, in the JAX package's order of accumulation.  `g1d`
    is the float32 numpy window; each tap multiplies as a float32
    scalar."""
    h, w = img.shape[-2:]
    taps = [float(v) for v in g1d]
    r = len(taps) // 2
    x = F.pad(img, (0, 0, r, r))
    out = taps[0] * x[:, :, 0:h, :]
    for i in range(1, len(taps)):
        out = out + taps[i] * x[:, :, i:i + h, :]
    x = F.pad(out, (r, r, 0, 0))
    out = taps[0] * x[:, :, :, 0:w]
    for i in range(1, len(taps)):
        out = out + taps[i] * x[:, :, :, i:i + w]
    return out


class SepGaussBlur(torch.autograd.Function):
    """`_sep_gauss_blur` with its hand-written VJP: the blur is a
    self-adjoint linear map (symmetric window, zero-padded SAME), so the
    gradient is the same blur applied to the cotangent.  The window is a
    constant and gets no gradient."""

    @staticmethod
    def forward(ctx, img, g1d):
        ctx.g1d = g1d
        return _sep_gauss_blur(img, g1d)

    @staticmethod
    def backward(ctx, ct):
        return _sep_gauss_blur(ct, ctx.g1d), None


def sep_gauss_blur(img: torch.Tensor, g1d) -> torch.Tensor:
    return SepGaussBlur.apply(img, g1d)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    # float32 before forming the second moments: sigma = E[x^2] - mu^2
    # cancels, and C2 = 9e-4 is below what a low-precision E[x^2] keeps
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    g1d = _gaussian_1d(window_size, 1.5)
    # one stacked blur over the five windowed moments
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=0)
    blurred = sep_gauss_blur(stacked, g1d)
    b = img1.shape[0]
    mu1, mu2, e11, e22, e12 = (blurred[i * b:(i + 1) * b] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Windowed SSIM identical to the reference implementation."""
    ssim_map = _ssim_map(img1, img2, window_size)
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def masked_ssim(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                window_size: int = 11) -> torch.Tensor:
    """SSIM over a validity mask [H, W]: both inputs are zeroed outside
    the mask and the map is averaged over valid pixels only."""
    m = mask.to(img1.dtype)
    mm = m if img1.dim() == 3 else m[None]
    ssim_map = _ssim_map(img1 * mm, img2 * mm, window_size)
    denom = torch.clamp_min(m.sum() * ssim_map.shape[1], 1.0)
    return (ssim_map * m[None, None]).sum() / denom
