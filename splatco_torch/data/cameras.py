"""Camera model (counterpart of splatco_tpu/data/cameras.py).

The matrices follow the 3DGS row-vector convention: `world_view_transform`
and `full_proj_transform` are stored TRANSPOSED and points transform as
`[p, 1] @ M`.  They are built in numpy float64 and cast to float32, exactly
as the JAX package builds them, then moved to the camera's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from splatco_torch.utils.device import resolve_device


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0
                  ) -> np.ndarray:
    """4x4 world->camera matrix. R is the COLMAP cam-to-world rotation
    (stored transposed by the readers), t the world->cam translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float
                      ) -> np.ndarray:
    """OpenGL-style perspective matrix in the 3DGS convention (z in [0,1],
    +z forward, no y-flip)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view; the tensors live on the camera's device."""
    world_view_transform: torch.Tensor  # [4,4], transposed
    full_proj_transform: torch.Tensor   # [4,4], world_view @ proj, transposed
    camera_center: torch.Tensor         # [3]
    image: Optional[torch.Tensor]       # [3,H,W] float in [0,1], or None
    R: torch.Tensor                     # [3,3] cam-to-world rotation
    T: torch.Tensor                     # [3] world->cam translation
    image_height: int
    image_width: int
    fovx: float
    fovy: float
    uid: int = 0
    znear: float = 0.01
    zfar: float = 100.0
    image_name: str = ""

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy * 0.5)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                image: Optional[np.ndarray], width: int, height: int,
                uid: int = 0, image_name: str = "",
                znear: float = 0.01, zfar: float = 100.0,
                trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0,
                device=None) -> Camera:
    dev = resolve_device(device)
    w2v = world_to_view(R, T, trans, scale).transpose()  # store transposed
    proj = projection_matrix(znear, zfar, fovx, fovy).transpose()
    full = (w2v @ proj).astype(np.float32)
    cam_center = np.linalg.inv(w2v)[3, :3].astype(np.float32)
    if image is not None:
        image = np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
        if image.shape != (3, height, width):
            raise ValueError(f"image shape {image.shape} is not "
                             f"{(3, height, width)}")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    return Camera(
        world_view_transform=t(w2v),
        full_proj_transform=t(full),
        camera_center=t(cam_center),
        image=None if image is None else t(image),
        R=t(R),
        T=t(T),
        image_height=height,
        image_width=width,
        fovx=float(fovx),
        fovy=float(fovy),
        znear=float(znear),
        zfar=float(zfar),
        uid=int(uid),
        image_name=image_name,
    )


def look_at_camera(eye, target, up, fovx, fovy, width, height,
                   image=None, uid=0, device=None) -> Camera:
    """Build a camera from an eye/target/up triple."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    dn = np.cross(fwd, right)
    # camera-to-world rotation with columns (right, down, forward): +x
    # right, +y down, +z forward in camera space
    Rc2w = np.stack([right, dn, fwd], axis=1)
    T = -Rc2w.T @ eye  # world->cam translation
    return make_camera(Rc2w, T, fovx, fovy, image, width, height, uid=uid,
                       device=device)
