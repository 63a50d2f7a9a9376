"""MERF-style scene contraction (counterpart of
splatco_tpu/models/contraction.py): the scene bbox maps linearly to
[-1,1], and the outside is warped into (-2,-1] / [1,2) by 2 - 1/|x|;
`decontract` maps back."""
from __future__ import annotations

import dataclasses

import torch

from splatco_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Contractor:
    xyz_min: torch.Tensor  # [3]
    xyz_max: torch.Tensor  # [3]
    enabled: bool = True


def make_contractor(center, length, bbox_scale: float, enabled: bool = True,
                    device=None) -> Contractor:
    """bbox = center +- length * bbox_scale / 2, on `device` (None: the
    card)."""
    dev = resolve_device(device)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    length = torch.as_tensor(length, dtype=torch.float32, device=dev)
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


def decontract(c: Contractor, xyz: torch.Tensor) -> torch.Tensor:
    """The inverse of `contract` with contraction on: unwarp |x| > 1
    (|x| clamped below 2), then map [-1, 1] back onto the bbox."""
    a = torch.abs(xyz)
    inv = torch.sign(xyz) / torch.clamp_min(
        1.0 - (torch.clamp_max(a, 2.0 - 1e-6) - 1.0), 1e-6)
    res = torch.where(a > 1.0, inv, xyz)
    return (res * (c.xyz_max - c.xyz_min) / 2.0
            + (c.xyz_max + c.xyz_min) / 2.0)
