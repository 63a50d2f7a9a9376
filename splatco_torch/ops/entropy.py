"""Entropy / rate models for compression-aware training (counterpart of
splatco_tpu/ops/entropy.py; the reference's Entropy_gaussian,
Entropy_factorized, Low_bound and UniverseQuant).  Latent in the
reference, which builds them and adds them to no loss; provided as plain
functions so a rate term can be added.

Where the JAX functions take a PRNG key, these take a torch.Generator.
`factorized_from_numpy` carries a factorized model's parameters over
from numpy arrays (the JAX package's, for instance)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

LOW_BOUND = 1e-6


class _LowBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, LOW_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # pass the gradient unless it would push x further below the
        # bound (the reference's Low_bound.backward)
        pass_through = (x >= LOW_BOUND) | (g < 0)
        return torch.where(pass_through, g, 0.0)


def low_bound(x: torch.Tensor) -> torch.Tensor:
    return _LowBound.apply(x)


def gaussian_bits(x, mean, scale, q: float = 1.0) -> torch.Tensor:
    """Estimated bits under a quantized gaussian prior: -log2 P(x in its
    Q-bin) (Entropy_gaussian.forward)."""
    scale = low_bound(torch.abs(scale))
    upper = torch.special.ndtr((x + 0.5 * q - mean) / scale)
    lower = torch.special.ndtr((x - 0.5 * q - mean) / scale)
    return -torch.log2(low_bound(upper - lower))


def universe_quant(generator: Optional[torch.Generator], x: torch.Tensor
                   ) -> torch.Tensor:
    """Universal quantization: round with a per-element uniform dither
    in [-0.5, 0.5) drawn from `generator`, with a straight-through
    gradient (UniverseQuant: round(x + u) - u; the backward passes g
    unchanged)."""
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device) - 0.5
    quant = torch.round(x + u) - u
    return x + (quant - x).detach()


def init_factorized(generator: Optional[torch.Generator], channels: int,
                    filters=(3, 3, 3), device=None
                    ) -> Dict[str, List[torch.Tensor]]:
    """Fully factorized entropy model parameters
    (Entropy_factorized.__init__): per layer, softplus-parameterized
    matrices [C, d_out, d_in], biases [C, d_out, 1] uniform in
    [-0.5, 0.5) and, but for the last layer, factors [C, d_out, 1]."""
    dims = (1,) + tuple(filters) + (1,)
    params: Dict[str, List[torch.Tensor]] = {"matrices": [], "biases": [],
                                             "factors": []}
    scale = 10.0
    for i in range(len(dims) - 1):
        init = float(np.log(np.expm1(1.0 / scale / dims[i + 1])))
        params["matrices"].append(torch.full(
            (channels, dims[i + 1], dims[i]), init, device=device))
        params["biases"].append(torch.rand(
            (channels, dims[i + 1], 1), generator=generator,
            device=device) - 0.5)
        if i < len(dims) - 2:
            params["factors"].append(
                torch.zeros((channels, dims[i + 1], 1), device=device))
    return params


def factorized_from_numpy(params, device=None
                          ) -> Dict[str, List[torch.Tensor]]:
    """A factorized model's {"matrices", "biases", "factors"} lists of
    arrays as float32 tensors on `device`."""
    return {k: [torch.tensor(np.asarray(a, np.float32), device=device)
                for a in v] for k, v in params.items()}


def _factorized_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x [C, 1, N] -> the cumulative's logits [C, 1, N]."""
    h = x
    n = len(params["matrices"])
    for i in range(n):
        m = F.softplus(params["matrices"][i])
        h = torch.einsum("cij,cjn->cin", m, h) + params["biases"][i]
        if i < n - 1:
            h = h + torch.tanh(params["factors"][i]) * torch.tanh(h)
    return h


def factorized_bits(params, x: torch.Tensor, q: float = 1.0
                    ) -> torch.Tensor:
    """x [N, C] -> estimated bits [N, C] under the factorized prior."""
    xt = x.T[:, None, :]  # [C, 1, N]
    upper = torch.sigmoid(_factorized_logits(params, xt + 0.5 * q))
    lower = torch.sigmoid(_factorized_logits(params, xt - 0.5 * q))
    return (-torch.log2(low_bound(upper - lower)))[:, 0, :].T
