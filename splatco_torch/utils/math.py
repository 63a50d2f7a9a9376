"""Small math helpers (counterpart of splatco_tpu/utils/math.py)."""
from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0
              ) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


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


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
