"""Photometric losses and image metrics (counterpart of
splatco_tpu/ops/losses.py).

l1 / ssim follow the reference (11x11 Gaussian window, sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2, zero-padded SAME depthwise filter); psnr is per
leading dim, so a [3,H,W] image yields per-channel PSNR.  All functions
take channel-first images [C,H,W] (or [B,C,H,W] for ssim) in [0,1].

SSIM runs on three hand-written CUDA kernels for a CUDA tensor: the
separable blur of the five stacked moments, both passes in one launch
(`sep_blur`, csrc/sep_blur.cu, also the blur's backward: it is
self-adjoint), the map from the blurred moments (`ssim_map_fwd`,
csrc/ssim_map_fwd.cu) and the map's VJP, which writes the stack's
gradient at once (`ssim_map_bwd`, csrc/ssim_map_bwd.cu; the arithmetic
of both in csrc/ssim.cuh).  Each call adds one to `cuda_lib.LAUNCHES`.
For CPU tensors the wrappers run the plain versions beside them
(`_sep_gauss_blur`, `_ssim_map_fwd_plain`, `_ssim_map_bwd_plain`); any
other device raises, and there is no fallback from one to the other.  The
kernels are built with --fmad=false and repeat their plain versions'
float32 operations in order, so on the card the two agree bit for bit.
The map's backward is a hand-written VJP on both, not autograd through
the formula.  `ssim` runs inside `torch.profiler.record_function("ssim")`
ranges, forward and backward.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from splatco_torch.ops import cuda_lib

BLUR_KERNEL = "sep_blur"
MAP_FWD_KERNEL = "ssim_map_fwd"
MAP_BWD_KERNEL = "ssim_map_bwd"
KERNELS = (BLUR_KERNEL, MAP_FWD_KERNEL, MAP_BWD_KERNEL)
MAX_TAPS = 31  # the blur kernel's widest window (radius 15)
# the SSIM constants, rounded to float32 where they meet a float32 tensor
C1, C2 = 0.01**2, 0.03**2


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


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _check_device(t: torch.Tensor, kernel: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.dtype != torch.float32:
        raise ValueError(f"{kernel} takes float32, got {t.dtype}")


def _check_window(g1d) -> None:
    taps = len(g1d)
    if taps % 2 == 0 or taps > MAX_TAPS:
        raise ValueError(f"{BLUR_KERNEL} takes an odd window of at most "
                         f"{MAX_TAPS} taps, got {taps}")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sep_blur(img: torch.Tensor, g1d) -> torch.Tensor:
    """`_sep_gauss_blur` of img [B, C, H, W]: the kernel for a CUDA
    tensor (float32, made contiguous), the plain version for a CPU one."""
    _check_window(g1d)
    _check_device(img, BLUR_KERNEL)
    if img.dim() != 4:
        raise ValueError(f"{BLUR_KERNEL} takes [B, C, H, W], got "
                         f"{tuple(img.shape)}")
    if img.device.type == "cpu":
        return _sep_gauss_blur(img, g1d)
    img = img.contiguous()
    b, c, h, w = img.shape
    out = torch.empty_like(img)
    taps = (ctypes.c_float * len(g1d))(*[float(v) for v in g1d])
    fn = cuda_lib.function(BLUR_KERNEL, (_P, _P, _I, _I, _I, _P, _I, _P))
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), out.data_ptr(), b * c, h, w, taps,
                 len(g1d), cuda_lib.stream(img.device))
    cuda_lib.launched(BLUR_KERNEL, err)
    return out


class SepGaussBlur(torch.autograd.Function):
    """`sep_blur` with its hand-written VJP: the blur is a self-adjoint
    linear map (symmetric window, zero-padded SAME), so the gradient is
    the same blur applied to the cotangent.  The window is a constant and
    gets no gradient."""

    @staticmethod
    def forward(ctx, img, g1d):
        ctx.g1d = g1d
        return sep_blur(img, g1d)

    @staticmethod
    def backward(ctx, ct):
        with torch.profiler.record_function("ssim"):
            return sep_blur(ct, ctx.g1d), None


def sep_gauss_blur(img: torch.Tensor, g1d) -> torch.Tensor:
    return SepGaussBlur.apply(img, g1d)


def _moments(stack: torch.Tensor):
    """mu1, mu2, E[x1^2], E[x2^2], E[x1 x2] of the blurred [5B, C, H, W]
    stack."""
    b = stack.shape[0] // 5
    return (stack[i * b:(i + 1) * b] for i in range(5))


def _ssim_map_fwd_plain(stack: torch.Tensor) -> torch.Tensor:
    """The SSIM map [B, C, H, W] from the blurred moments."""
    mu1, mu2, e11, e22, e12 = _moments(stack)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def _ssim_map_bwd_plain(g: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """The map's VJP: the gradient [5B, C, H, W] of the blurred moments for
    the map's cotangent g [B, C, H, W].
    With num = a b and den = d e, a = 2 mu1 mu2 + C1, b = 2 sigma12 + C2,
    d = mu1^2 + mu2^2 + C1, e = sigma1^2 + sigma2^2 + C2: g_num = g / den,
    g_den = -g (num / den) / den (autograd's division rule), and the
    chain rule through a, b, d, e to the moments."""
    mu1, mu2, e11, e22, e12 = _moments(stack)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    a = 2 * mu1_mu2 + C1
    b = 2 * (e12 - mu1_mu2) + C2
    d = mu1_sq + mu2_sq + C1
    e = (e11 - mu1_sq) + (e22 - mu2_sq) + C2
    den = d * e
    g_num = g / den
    g_den = -g * (a * b / den / den)
    g_b = g_num * a
    g_e = g_den * d
    g_mu1_mu2 = 2 * (g_num * b) - 2 * g_b
    g_sq = g_den * e - g_e
    return torch.cat([2 * mu1 * g_sq + mu2 * g_mu1_mu2,
                      2 * mu2 * g_sq + mu1 * g_mu1_mu2,
                      g_e, g_e, 2 * g_b])


def _check_stack(stack: torch.Tensor, kernel: str) -> None:
    _check_device(stack, kernel)
    if stack.dim() != 4 or stack.shape[0] % 5:
        raise ValueError(f"{kernel} takes a [5B, C, H, W] stack, got "
                         f"{tuple(stack.shape)}")


def ssim_map_fwd(stack: torch.Tensor) -> torch.Tensor:
    """The SSIM map [B, C, H, W] from the blurred moments [5B, C, H, W]:
    the kernel for a CUDA tensor, the plain version for a CPU one."""
    _check_stack(stack, MAP_FWD_KERNEL)
    if stack.device.type == "cpu":
        return _ssim_map_fwd_plain(stack)
    stack = stack.contiguous()
    out = torch.empty((stack.shape[0] // 5, *stack.shape[1:]),
                      dtype=torch.float32, device=stack.device)
    fn = cuda_lib.function(MAP_FWD_KERNEL, (_P, _L, ctypes.c_float,
                                            ctypes.c_float, _P, _I, _P))
    with torch.cuda.device(stack.device):
        err = fn(stack.data_ptr(), out.numel(), C1, C2, out.data_ptr(),
                 _sms(stack.device), cuda_lib.stream(stack.device))
    cuda_lib.launched(MAP_FWD_KERNEL, err)
    return out


def ssim_map_bwd(g: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """The gradient [5B, C, H, W] of the blurred moments for the map's
    cotangent g [B, C, H, W]: the kernel for CUDA tensors (made
    contiguous), the plain version for CPU ones."""
    _check_stack(stack, MAP_BWD_KERNEL)
    _check_device(g, MAP_BWD_KERNEL)
    shape = (stack.shape[0] // 5, *stack.shape[1:])
    if g.shape != shape or g.device != stack.device:
        raise ValueError(f"{MAP_BWD_KERNEL}: the cotangent must be "
                         f"{shape} on {stack.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if stack.device.type == "cpu":
        return _ssim_map_bwd_plain(g, stack)
    stack, g = stack.contiguous(), g.contiguous()
    d_stack = torch.empty_like(stack)
    fn = cuda_lib.function(MAP_BWD_KERNEL, (_P, _P, _L, ctypes.c_float,
                                            ctypes.c_float, _P, _I, _P))
    with torch.cuda.device(stack.device):
        err = fn(g.data_ptr(), stack.data_ptr(), g.numel(), C1, C2,
                 d_stack.data_ptr(), _sms(stack.device),
                 cuda_lib.stream(stack.device))
    cuda_lib.launched(MAP_BWD_KERNEL, err)
    return d_stack


class _SSIMMap(torch.autograd.Function):
    """The SSIM map of the blurred moments with its hand-written VJP; it
    keeps only the stack for the backward."""

    @staticmethod
    def forward(ctx, stack):
        ctx.save_for_backward(stack)
        return ssim_map_fwd(stack)

    @staticmethod
    def backward(ctx, g):
        (stack,) = ctx.saved_tensors
        with torch.profiler.record_function("ssim"):
            return ssim_map_bwd(g, stack)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    with torch.profiler.record_function("ssim"):
        if img1.dim() == 3:
            img1 = img1[None]
            img2 = img2[None]
        # float32 before forming the second moments: sigma = E[x^2] - mu^2
        # cancels, and C2 = 9e-4 is below what a low-precision E[x^2] keeps
        img1 = img1.to(torch.float32)
        img2 = img2.to(torch.float32)
        g1d = _gaussian_1d(window_size, 1.5)
        # one stacked blur over the five windowed moments
        stacked = torch.cat([img1, img2, img1 * img1, img2 * img2,
                             img1 * img2], dim=0)
        return _SSIMMap.apply(sep_gauss_blur(stacked, g1d))


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
