"""MLP / BatchNorm primitives over plain dicts of tensors (counterpart of
splatco_tpu/models/mlp.py).

Masked BatchNorm: the reference's fusion MLPs use a BatchNorm1d that stays
in TRAIN mode even at eval, so activations are always normalized by the
current batch statistics.  Batches here are fixed-capacity padded arrays,
so the statistics are taken over the masked rows only, with a biased
variance E[x^2] - mean^2 and eps=1e-5.  `nn.BatchNorm1d` computes the
variance another way, so it is written out by hand.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from splatco_torch.parallel.collectives import all_reduce_sum

Linear = Dict[str, torch.Tensor]


def init_linear(in_dim: int, out_dim: int, generator: torch.Generator
                ) -> Linear:
    """torch nn.Linear default init: weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in)).  Weight layout [in, out] (x @ w), as in the JAX
    package."""
    bound = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {"w": u(in_dim, out_dim), "b": u(out_dim)}


def linear(params: Linear, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def init_batchnorm(dim: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def masked_batchnorm(params, x: torch.Tensor, mask: torch.Tensor,
                     eps: float = 1e-5, group=None) -> torch.Tensor:
    """Train-mode BN over the masked rows of x [N, D]; mask [N] bool.

    With `group` (parallel/collectives.Group), x is one shard of the rows:
    the count and the two sums are summed over the group before the mean
    and variance, and their gradients flow back through that sum."""
    m = mask.to(x.dtype)[:, None]
    cnt = m.sum()
    s1 = (x * m).sum(dim=0)
    s2 = ((x * x) * m).sum(dim=0)
    if group is not None:
        d = s1.shape[0]
        sums = all_reduce_sum(torch.cat([cnt[None], s1, s2]), group)
        cnt, s1, s2 = sums[0], sums[1:1 + d], sums[1 + d:]
    cnt = torch.clamp_min(cnt, 1.0)
    mean = s1 / cnt
    var = torch.clamp_min(s2 / cnt - mean * mean, 0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def init_mlp(dims: Sequence[int], generator: torch.Generator
             ) -> List[Linear]:
    return [init_linear(i, o, generator) for i, o in zip(dims[:-1], dims[1:])]


def mlp(params: List[Linear], x: torch.Tensor,
        final_act: Optional[str] = None) -> torch.Tensor:
    """ReLU between layers, optional final activation
    (None | 'tanh' | 'sigmoid' | 'softmax')."""
    for i, layer in enumerate(params):
        x = linear(layer, x)
        if i < len(params) - 1:
            x = torch.relu(x)
    if final_act == "tanh":
        x = torch.tanh(x)
    elif final_act == "sigmoid":
        x = torch.sigmoid(x)
    elif final_act == "softmax":
        x = torch.softmax(x, dim=-1)
    return x
