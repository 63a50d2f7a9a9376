"""Small math helpers (counterpart of splatco_tpu/utils/math.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0
              ) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), any norm, -> rotation matrix [..., 3, 3]
    (normalized first, as the reference's build_rotation)."""
    q = normalize(q, eps=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_covariance(scaling: torch.Tensor, rotation_quat: torch.Tensor
                     ) -> torch.Tensor:
    """3D covariance Sigma = R S^2 R^T [..., 3, 3] from activated scales
    [..., 3] and quaternions [..., 4]."""
    L = quat_to_rotmat(rotation_quat) * scaling[..., None, :]  # R @ diag(s)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric [..., 3, 3] -> its 6 unique coefficients [..., 6] (xx,
    xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)


def unstrip_symmetric(six: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: [..., 6] -> [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = six.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000
             ) -> torch.Tensor:
    """Log-linearly interpolated LR schedule with an optional delay ramp,
    in float32 as the JAX package computes it; 0 when step < 0 or both
    rates are 0.  `step` is a Python number or a tensor (the result lies
    on its device)."""
    step = torch.as_tensor(step).to(torch.float32)

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=step.device)

    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.clamp_min(const(lr_init), 1e-30))
                         * (1 - t)
                         + torch.log(torch.clamp_min(const(lr_final), 1e-30))
                         * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    lr = delay_rate * log_lerp
    valid = (step >= 0) & ((lr_init != 0.0) or (lr_final != 0.0))
    return torch.where(valid, lr, 0.0)


def pad_to(arr, n: int, axis: int = 0, value=0):
    """`arr` (a numpy array or a tensor) padded with `value` along `axis`
    to length n."""
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"cannot pad {cur} down to {n}")
    if isinstance(arr, np.ndarray):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, n - cur)
        return np.pad(arr, widths, constant_values=value)
    shape = list(arr.shape)
    shape[axis] = n - cur
    return torch.cat([arr, arr.new_full(shape, value)], dim=axis)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
