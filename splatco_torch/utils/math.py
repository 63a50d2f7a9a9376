"""Small math helpers (counterpart of splatco_tpu/utils/math.py)."""
from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0
              ) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
