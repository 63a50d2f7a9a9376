"""Dense alpha-blend compositor, the plain oracle (counterpart of
splatco_tpu/ops/rasterize_reference.py) and the `backend="dense"` of the
render and training paths.

Per pixel, the blend semantics of the tile kernels:

  * gaussians front to back in stable (depth, index) order, culled ones
    (radius 0) last and never drawn,
  * G = exp(-0.5*(a*dx^2 + c*dy^2) - b*dx*dy), d = mean2d - pixel,
  * skip when power > 0; alpha = min(0.99, opacity * G); skip when
    alpha < 1/255,
  * a pixel stops when T * (1 - alpha) < 1e-4, BEFORE that gaussian
    contributes,
  * colour = sum(c_i * alpha_i * T_i) + bg * T_final.

With `tile_size`, a gaussian reaches only the pixels whose tile lies in
its unclipped tile rect, the visibility of the binned kernels, so the two
agree to rounding wherever no rect is clipped to kmax.

It is O(N * H * W): the gaussians go in chunks, each chunk's transmittance
a cumulative product over its [chunk, H*W] alphas.  The culled gaussians,
sorted last, are left out (they add exact zeros), which costs one read of
their count on the host.  Everything is torch operations, so autograd
differentiates it (means, conics, colours, opacities, bg); it is the
ground truth the kernel path is held to.
"""
from __future__ import annotations

from typing import Optional

import torch

from splatco_torch.ops.projection import ProjectedCols, rect_bounds

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def depth_order(depths: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable front-to-back order with invalid entries pushed to the
    back."""
    key = torch.where(valid, depths, torch.inf)
    return torch.argsort(key, stable=True)


def rasterize_dense(proj: ProjectedCols, colors: torch.Tensor,
                    opacities: torch.Tensor, bg: torch.Tensor,
                    image_height: int, image_width: int, chunk: int = 256,
                    tile_size: Optional[int] = None):
    """(image [C, H, W], final_T [H, W]) of `proj`'s gaussians with
    colours [N, C] and opacities [N] over background bg [C]."""
    dev = proj.mx.device
    hw = image_height * image_width
    radius = proj.radius.to(torch.float32)
    valid = radius > 0
    order = depth_order(proj.depth, valid)
    n = int(valid.sum())
    order = order[:n]
    mx, my = proj.mx[order], proj.my[order]
    ca, cb, cc = proj.ca[order], proj.cb[order], proj.cc[order]
    cols, opac, valid = colors[order], opacities[order], valid[order]

    py = torch.arange(image_height, dtype=torch.float32,
                      device=dev).repeat_interleave(image_width)
    px = torch.arange(image_width, dtype=torch.float32,
                      device=dev).repeat(image_height)
    if tile_size is not None:
        rects = torch.stack(rect_bounds(
            mx.detach(), my.detach(), radius[order], tile_size,
            -(-image_width // tile_size), -(-image_height // tile_size)),
            dim=-1)
        ptx = (px / tile_size).to(torch.int32)
        pty = (py / tile_size).to(torch.int32)

    T = torch.ones(hw, device=dev)
    acc = torch.zeros((colors.shape[-1], hw), device=dev)
    done = torch.zeros(hw, dtype=torch.bool, device=dev)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        dx = mx[sl, None] - px[None, :]                    # [chunk, HW]
        dy = my[sl, None] - py[None, :]
        power = (-0.5 * (ca[sl, None] * dx * dx + cc[sl, None] * dy * dy)
                 - cb[sl, None] * dx * dy)
        alpha = torch.clamp_max(opac[sl, None] * torch.exp(power), ALPHA_MAX)
        live = valid[sl, None] & (power <= 0) & (alpha >= ALPHA_MIN)
        if tile_size is not None:
            r = rects[sl]
            live = (live & (ptx[None, :] >= r[:, 0:1])
                    & (ptx[None, :] < r[:, 2:3])
                    & (pty[None, :] >= r[:, 1:2])
                    & (pty[None, :] < r[:, 3:4]))
        alpha = torch.where(live, alpha, 0.0)

        # front to back within the chunk by a cumulative product: the
        # T values assuming every live gaussian contributes are right up
        # to and including the first would-terminate event, and
        # everything after it is masked out
        one_m = 1.0 - alpha
        cp = torch.cumprod(one_m, dim=0)
        t_before = T[None, :] * torch.cat([torch.ones_like(cp[:1]), cp[:-1]])
        would_terminate = live & (T[None, :] * cp < T_EPS)
        after_first = torch.cat(
            [torch.zeros_like(would_terminate[:1]),
             torch.cumsum(would_terminate[:-1].to(torch.int32), dim=0) > 0])
        contrib = live & ~done[None, :] & ~would_terminate & ~after_first
        w = torch.where(contrib, alpha * t_before, 0.0)    # [chunk, HW]
        acc = acc + cols[sl].T @ w
        T = T * torch.where(contrib, one_m, 1.0).prod(dim=0)
        done = done | would_terminate.any(dim=0)
    image = acc + bg[:, None] * T[None, :]
    return (image.reshape(-1, image_height, image_width),
            T.reshape(image_height, image_width))
