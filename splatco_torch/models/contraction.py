"""MERF-style scene contraction (counterpart of
splatco_tpu/models/contraction.py): the scene bbox maps linearly to
[-1,1], and the outside is warped into (-2,-1] / [1,2) by 2 - 1/|x|."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Contractor:
    xyz_min: torch.Tensor  # [3]
    xyz_max: torch.Tensor  # [3]
    enabled: bool = True


def make_contractor(center, length, bbox_scale: float, enabled: bool = True,
                    device: torch.device = torch.device("cpu")
                    ) -> Contractor:
    """bbox = center +- length * bbox_scale / 2."""
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    length = torch.as_tensor(length, dtype=torch.float32, device=device)
    half = length * bbox_scale / 2.0
    return Contractor(xyz_min=center - half, xyz_max=center + half,
                      enabled=enabled)


def contract(c: Contractor, xyz: torch.Tensor) -> torch.Tensor:
    ind = (xyz - c.xyz_min) * 2.0 / (c.xyz_max - c.xyz_min) - 1.0
    if not c.enabled:
        return ind
    a = torch.abs(ind)
    warped = torch.sign(ind) * (2.0 - 1.0 / torch.clamp_min(a, 1.0))
    return torch.where(a > 1.0, warped, ind)
