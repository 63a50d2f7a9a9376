"""The tri-plane sampler: bilinear samples of a plane [R, H, W] at
normalized coordinates (u on the H axis, v on the W axis, both in
[-1, 1], align_corners, zeros outside), with a hand-written gradient.
Counterpart of `_sample_plane` in splatco_tpu/models/triplane.py, an XLA
gather there (and its `jax.grad` an XLA scatter-add), here a pair of CUDA
kernels: `csrc/plane_sample_fwd.cu` and `csrc/plane_sample_bwd.cu`.

`sample_plane(plane, u, v)` is the autograd entry point, [N] -> [N, R];
its forward keeps only the plane and the coordinates for the backward.
The backward sums each texel's entries g[n, r] * weight(n, corner)
exactly, as integers: each float32 product is scaled by a power of two
2**k, rounded half to even to int64, and the int64 sums are converted to
float32 once and scaled back by 2**-k.  Integer addition is associative,
so the sums do not depend on their order (the kernel adds them with
atomics, split across blocks as it likes): no float atomic, no sort, and
a step repeats bit for bit.  k (`grad_exponent`, from integer exponents)
keeps N * max|g| * 2**k <= 2**62, within a factor of 4 of the largest k
that does, so no sum can overflow (a row's in-bounds weights sum to at
most 1); it is clamped to [-126, 126].  The resolution 2**-k is thus
about N * max|g| * 2**-62, and each d_plane value is the float32
rounding of a number within entries * 2**-(k + 1) of the exact sum of
its entries' float32 products (entries: the rows whose corners reach
that texel).  A cotangent with a NaN or an inf gives a d_plane of NaN.
The coordinates' gradients are per row.

For CUDA tensors `plane_sample_fwd` and `plane_sample_bwd` launch their
kernels (each call adds one to `cuda_lib.LAUNCHES`); for CPU tensors they
run the plain versions beside them; any other device raises.  There is no
fallback from one to the other.  The plain versions repeat the kernels'
float32 operations (the kernels are built with --fmad=false) and their
integer sums, so on the same inputs the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from splatco_torch.ops import cuda_lib

FWD_KERNEL = "plane_sample_fwd"
BWD_KERNEL = "plane_sample_bwd"
# the backward's int64 sums of a 32 x 32 texel tile live in a block's
# shared memory (R x 8 KiB), at most 227 KiB
MAX_R = 28


def _cell(u: torch.Tensor, v: torch.Tensor, h: int, w: int):
    """(x0, y0, tx, ty) of rows (u, v): the texel lattice coordinates'
    floors and fractions (`cell_of` in csrc/plane_sample.cuh)."""
    x = (u + 1.0) * 0.5 * (h - 1)
    y = (v + 1.0) * 0.5 * (w - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0, y0, x - x0, y - y0


def _corner(cell, k, h: int, w: int):
    """Corner k of `cell` (bit 0 steps x, bit 1 steps y; an int or a
    tensor of them): (weight, in-bounds, flat index clamped onto the
    plane) (`corner` in csrc/plane_sample.cuh)."""
    x0, y0, tx, ty = cell
    k = torch.as_tensor(k, device=x0.device)
    sx, sy = (k & 1) == 1, (k & 2) == 2
    cx = torch.where(sx, x0 + 1, x0)
    cy = torch.where(sy, y0 + 1, y0)
    wgt = torch.where(sx, tx, 1 - tx) * torch.where(sy, ty, 1 - ty)
    inb = (cx >= 0) & (cx <= h - 1) & (cy >= 0) & (cy <= w - 1)
    idx = (torch.clamp(cx, 0, h - 1).to(torch.int64) * w
           + torch.clamp(cy, 0, w - 1).to(torch.int64))
    return wgt, inb, idx


def plane_sample_fwd_plain(plane: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample plane [R, H, W] at normalized coords u (H axis),
    v (W axis) in [-1, 1]; align_corners=True, zeros outside.  [N] -> [N,R].
    The four corners are gathered and weighted explicitly, each texel
    times (weight times its in-bounds flag), summed in corner order."""
    r, h, w = plane.shape
    flat = plane.reshape(r, h * w)
    cell = _cell(u, v, h, w)
    out = None
    for k in range(4):
        wgt, inb, idx = _corner(cell, k, h, w)
        term = flat[:, idx] * (wgt * inb.to(plane.dtype))[None, :]
        out = term if out is None else out + term
    return out.T


def grad_exponent(max_abs: float, n: int) -> int:
    """k of the backward's scale 2**k for a cotangent whose largest |value|
    is `max_abs` over `n` rows: k = 62 - b - e from integer exponents
    alone (max_abs < 2**e, e = -126 below float32's normal range;
    n <= 2**b), so n * max_abs * 2**k <= 2**62, clamped to [-126, 126] so
    that 2**k and 2**-k are normal float32 values (`grad_exponent` in
    csrc/plane_sample_bwd.cu)."""
    e = max(math.frexp(max_abs)[1], -126)
    b = max(n - 1, 0).bit_length()
    return min(max(62 - b - e, -126), 126)


def _plane_grad_plain(g, u, v, plane) -> torch.Tensor:
    """d_plane [R, H, W]: each corner's float32 product g * weight, scaled
    by 2**k, rounded half to even to int64 and summed exactly by
    `index_add_`, then converted once and scaled back."""
    r, h, w = plane.shape
    n = u.shape[0]
    max_abs = float(g.abs().max()) if g.numel() else 0.0
    if not math.isfinite(max_abs):
        return torch.full_like(plane, float("nan"))
    k = grad_exponent(max_abs, n)
    cell = _cell(u, v, h, w)
    acc = torch.zeros((r, h * w), dtype=torch.int64, device=plane.device)
    for c in range(4):
        wgt, inb, idx = _corner(cell, c, h, w)
        val = g[inb] * wgt[inb][:, None]
        acc.index_add_(1, idx[inb],
                       torch.round(val * 2.0 ** k).to(torch.int64).T)
    return (acc.to(plane.dtype) * 2.0 ** -k).view(r, h, w)


def _coord_grads_plain(g, u, v, plane):
    """(d_u, d_v) [N] in the backward kernel's order: the channels summed
    one after another."""
    r, h, w = plane.shape
    flat = plane.reshape(r, h * w)
    cell = _cell(u, v, h, w)
    corners = [_corner(cell, k, h, w)[1:] for k in range(4)]
    _, _, tx, ty = cell
    dtx = torch.zeros_like(u)
    dty = torch.zeros_like(u)
    for ch in range(r):
        c00, c10, c01, c11 = (flat[ch, idx] * inb.to(plane.dtype)
                              for inb, idx in corners)
        gr = g[:, ch]
        dtx = dtx + gr * ((1 - ty) * (c10 - c00) + ty * (c11 - c01))
        dty = dty + gr * ((1 - tx) * (c01 - c00) + tx * (c11 - c10))
    return dtx * (h - 1) * 0.5, dty * (w - 1) * 0.5


def plane_sample_bwd_plain(g: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, plane: torch.Tensor,
                           plane_grad: bool = True, coords: bool = True):
    """The sampler's gradients for the output cotangent g [N, R]:
    (d_plane [R, H, W] or None without `plane_grad`, d_u, d_v [N] or None
    without `coords`), each as the backward kernel computes it."""
    d_plane = _plane_grad_plain(g, u, v, plane) if plane_grad else None
    d_u, d_v = (_coord_grads_plain(g, u, v, plane) if coords
                else (None, None))
    return d_plane, d_u, d_v


def _check(plane, u, v):
    if plane.dim() != 3 or not plane.is_contiguous():
        raise ValueError(f"plane must be a contiguous [R, H, W], got "
                         f"{tuple(plane.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.dim() != 1 or t.shape != u.shape or t.device != plane.device \
                or t.dtype != plane.dtype:
            raise ValueError(f"{name} must be [N] {plane.dtype} on "
                             f"{plane.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if plane.device.type == "cuda" and plane.dtype != torch.float32:
        raise ValueError(f"{FWD_KERNEL} takes float32, got {plane.dtype}")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{FWD_KERNEL}: unsupported device {plane.device}")
    r, h, w = plane.shape
    if 4 * u.shape[0] >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError("the backward's int32 entries cannot hold "
                         f"{u.shape[0]} rows of a {h}x{w} plane")
    if plane.device.type == "cuda" and r > MAX_R:
        raise ValueError(f"the kernels take at most {MAX_R} channels, got "
                         f"{r}")


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def plane_sample_fwd(plane: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Samples [N, R] of plane [R, H, W] at rows (u, v)."""
    _check(plane, u, v)
    if plane.device.type == "cpu":
        return plane_sample_fwd_plain(plane, u, v)
    r, h, w = plane.shape
    n = u.shape[0]
    out = torch.empty((n, r), dtype=torch.float32, device=plane.device)
    fn = cuda_lib.function(FWD_KERNEL,
                           (_P, _P, _L, _P, _L, _L, _I, _I, _I, _P, _P))
    with torch.cuda.device(plane.device):
        err = fn(plane.data_ptr(), u.data_ptr(), u.stride(0), v.data_ptr(),
                 v.stride(0), n, r, h, w, out.data_ptr(),
                 cuda_lib.stream(plane.device))
    cuda_lib.launched(FWD_KERNEL, err)
    return out


@functools.lru_cache(maxsize=None)
def _scratch_sizes_fn():
    fn = cuda_lib.load(BWD_KERNEL).plane_sample_bwd_scratch
    fn.argtypes = [_L, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    return fn


def plane_sample_bwd(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     plane: torch.Tensor, plane_grad: bool = True,
                     coords: bool = True):
    """(d_plane [R, H, W] or None without `plane_grad`, d_u, d_v [N] or
    None without `coords`) for the output cotangent g [N, R]."""
    _check(plane, u, v)
    r, h, w = plane.shape
    n = u.shape[0]
    if g.shape != (n, r) or g.dtype != plane.dtype \
            or g.device != plane.device:
        raise ValueError(f"g must be [{n}, {r}] {plane.dtype} on "
                         f"{plane.device}, got {g.dtype} {tuple(g.shape)}")
    if plane.device.type == "cpu":
        return plane_sample_bwd_plain(g, u, v, plane, plane_grad, coords)
    if g.stride(1) != 1:
        g = g.contiguous()
    dev = plane.device
    d_plane = ints = wide = None
    if plane_grad:
        sizes = (ctypes.c_longlong * 2)()
        _scratch_sizes_fn()(n, r, h, w, sizes)
        d_plane = torch.empty_like(plane)
        ints = torch.empty(sizes[0], dtype=torch.int32, device=dev)
        wide = torch.empty(sizes[1], dtype=torch.int64, device=dev)
    d_u = torch.empty(n, dtype=torch.float32, device=dev) if coords else None
    d_v = torch.empty(n, dtype=torch.float32, device=dev) if coords else None
    fn = cuda_lib.function(BWD_KERNEL, (_P, _L, _P, _L, _P, _L, _P, _L, _I,
                                        _I, _I, _P, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), g.stride(0), u.data_ptr(), u.stride(0),
                 v.data_ptr(), v.stride(0), plane.data_ptr(), n, r, h, w,
                 _ptr(ints), _ptr(wide), _ptr(d_plane), _ptr(d_u),
                 _ptr(d_v), cuda_lib.stream(dev))
    cuda_lib.launched(BWD_KERNEL, err)
    return d_plane, d_u, d_v


class _PlaneSample(torch.autograd.Function):
    """The sampler with its hand-written gradient."""

    @staticmethod
    def forward(ctx, plane, u, v):
        with torch.profiler.record_function("plane_sample"):
            out = plane_sample_fwd(plane, u, v)
        ctx.save_for_backward(plane, u, v)
        return out

    @staticmethod
    def backward(ctx, g):
        plane, u, v = ctx.saved_tensors
        need_plane, need_u, need_v = ctx.needs_input_grad
        with torch.profiler.record_function("plane_sample"):
            d_plane, d_u, d_v = plane_sample_bwd(
                g, u, v, plane, plane_grad=need_plane,
                coords=need_u or need_v)
        return (d_plane, d_u if need_u else None, d_v if need_v else None)


def sample_plane(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample plane [R, H, W] at normalized coords u (H axis), v
    (W axis) in [-1, 1]; align_corners=True, zeros outside.  [N] -> [N, R],
    differentiable in all three."""
    if torch.is_grad_enabled() and (plane.requires_grad or u.requires_grad
                                    or v.requires_grad):
        return _PlaneSample.apply(plane, u, v)
    with torch.profiler.record_function("plane_sample"):
        return plane_sample_fwd(plane, u, v)
