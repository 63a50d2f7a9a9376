"""Synthetic scenes on disk (the COLMAP and Blender writers of
splatco_tpu/utils/synthetic.py): a procedural coloured-gaussian cloud
rendered from orbit cameras, so the data layer and the render CLI run
end to end without an external dataset.

The camera files (`cameras.bin`, `images.bin`, `points3D.bin`,
`transforms_*.json`) and the point clouds are the JAX writers' byte for
byte.  The ground-truth images are rendered through the port's own
`rasterize` (the binned path, the blend kernel on the card) with a
`kmax` that clips no gaussian, where the JAX writers use their dense
oracle, and written with data/images.py.
"""
from __future__ import annotations

import json
import math
import os
import struct

import numpy as np
import torch

from splatco_torch.data.cameras import Camera, fov2focal, look_at_camera
from splatco_torch.data.colmap import CAMERA_MODEL_IDS, rotmat2qvec
from splatco_torch.data.images import save_png
from splatco_torch.data.ply import store_point_cloud
from splatco_torch.ops.binning import TILE
from splatco_torch.ops.projection import project_gaussians_cols
from splatco_torch.ops.rasterize import rasterize
from splatco_torch.utils.device import resolve_device


def make_cloud(n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.45
    colors = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    return pts, colors


def orbit_camera(i: int, total: int, radius: float = 3.0,
                 height: float = 0.6, width: int = 96, height_px: int = 64,
                 fovx: float = 1.0, device=None) -> Camera:
    th = 2 * math.pi * i / total
    eye = [radius * math.cos(th), height, radius * math.sin(th)]
    return look_at_camera(eye, [0, 0, 0], [0, -1, 0], fovx,
                          fovx * height_px / width, width, height_px, uid=i,
                          device=device)


def render_gt(pts, colors, cam: Camera, scale: float = 0.04) -> np.ndarray:
    """[3,H,W] in [0,1]: isotropic gaussians of `scale`, opacity 0.8,
    over a white background."""
    dev = cam.world_view_transform.device
    n = pts.shape[0]
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    with torch.inference_mode():
        proj = project_gaussians_cols(
            torch.as_tensor(pts, device=dev),
            torch.full((n, 3), scale, device=dev), quats, cam)
        span = math.ceil(2.0 * float(proj.radius.max()) / TILE) + 1
        img, aux = rasterize(proj, torch.as_tensor(colors, device=dev),
                             torch.full((n,), 0.8, device=dev),
                             torch.ones(3, device=dev), cam.image_height,
                             cam.image_width, kmax=span * span,
                             return_aux=True)
        if int(aux["num_clipped"]):
            raise AssertionError("the ground-truth render clipped gaussians")
        return img.clamp(0.0, 1.0).cpu().numpy()


def write_colmap_dataset(path: str, n_views: int = 12, n_pts: int = 300,
                         width: int = 96, height: int = 64, seed: int = 0,
                         device=None) -> None:
    """A synthetic scene in COLMAP binary layout: <path>/images/*.png and
    <path>/sparse/0/{cameras,images,points3D}.bin, one shared PINHOLE
    camera, views on an orbit, a noisy copy of the cloud as points.  The
    images are rendered on `device` (None: the card)."""
    dev = resolve_device(device)
    img_dir = os.path.join(path, "images")
    sparse = os.path.join(path, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse, exist_ok=True)
    pts, colors = make_cloud(n_pts, seed)
    fovx = 1.0
    fy = fov2focal(fovx * height / width, height)
    fx = fov2focal(fovx, width)

    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, CAMERA_MODEL_IDS["PINHOLE"],
                             width, height))
        fh.write(struct.pack("<dddd", fx, fy, width / 2.0, height / 2.0))

    # per-view qvec/tvec in COLMAP's world-to-camera convention
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            cam = orbit_camera(i, n_views, width=width, height_px=height,
                               fovx=fovx, device=dev)
            name = f"frame_{i:04d}.png"
            save_png(os.path.join(img_dir, name),
                     render_gt(pts, colors, cam))
            w2c = cam.world_view_transform.cpu().numpy().T
            qvec = rotmat2qvec(w2c[:3, :3])
            tvec = w2c[:3, 3]
            fh.write(struct.pack("<i", i + 1))
            fh.write(struct.pack("<dddd", *qvec))
            fh.write(struct.pack("<ddd", *tvec))
            fh.write(struct.pack("<i", 1))
            fh.write(name.encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))  # no 2D points

    rng = np.random.default_rng(seed + 1)
    noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02
    rgb8 = (colors * 255).astype(np.uint8)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            fh.write(struct.pack("<QdddBBBd", i + 1, *noisy[i].tolist(),
                                 *rgb8[i].tolist(), 0.5))
            fh.write(struct.pack("<Q", 0))  # track length


def write_blender_dataset(path: str, n_views: int = 12, n_pts: int = 400,
                          width: int = 96, height: int = 64, seed: int = 0,
                          device=None) -> None:
    """transforms_{train,test}.json + renders + points3d.ply; the images
    are rendered on `device` (None: the card)."""
    dev = resolve_device(device)
    os.makedirs(path, exist_ok=True)
    pts, colors = make_cloud(n_pts, seed)
    fovx = 1.0

    def dump(split: str, idxs):
        frames = []
        for i in idxs:
            cam = orbit_camera(i, n_views, width=width, height_px=height,
                               fovx=fovx, device=dev)
            fname = f"r_{i}"
            save_png(os.path.join(path, split, fname + ".png"),
                     render_gt(pts, colors, cam))
            # camera-to-world in OpenGL axes (the reader flips them back)
            w2v = cam.world_view_transform.cpu().numpy().T
            c2w = np.linalg.inv(w2v)
            c2w[:3, 1:3] *= -1
            frames.append({"file_path": f"{split}/{fname}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(path, f"transforms_{split}.json"),
                  "w") as fh:
            json.dump({"camera_angle_x": fovx, "frames": frames}, fh)

    dump("train", [i for i in range(n_views) if i % 4 != 0])
    dump("test", [i for i in range(n_views) if i % 4 == 0])
    rng = np.random.default_rng(seed + 1)
    noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02
    store_point_cloud(os.path.join(path, "points3d.ply"), noisy,
                      colors * 255)
