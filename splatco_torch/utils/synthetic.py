"""Synthetic scenes on disk (the COLMAP, Blender and hard-protocol
writers of splatco_tpu/utils/synthetic.py): a procedural coloured-gaussian
cloud rendered from orbit cameras, so the data layer and the render CLI
run end to end without an external dataset.  The hard protocol's scene
(`write_hard_dataset`) has sharp detail, a sparse noisy init and a rig
of close and far cameras, so that densification, pruning and CVPM have
work to do.

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


# the inner-arc rig shared by hard_camera (its stations) and
# make_hard_cloud (the bead string on the stations' chords): station k
# sits at angle ARC_TH0 + ARC_DTH*k, radius ARC_R, height ARC_Y0 +
# ARC_DY*k, looking through the origin
ARC_TH0, ARC_DTH = 0.9, 0.06
ARC_R = 0.45
ARC_Y0, ARC_DY = 0.10, 0.006
ARC_STATIONS = 9        # stations of the default 28-view rig (i % 3 == 2)


def make_hard_cloud(n: int = 3500, seed: int = 0):
    """(points [n, 3], colours [n, 3]) float32 of the hard scene: a
    checkerboard sphere shell, a striped torus, a dense core cluster, 8
    far outliers (radius 3.4-4.2, past 3 sigma of the cloud, where CVPM's
    outlier branch can classify them) and a string of 64 beads lying on
    the inner-arc cameras' chords, the anchors CVPM's near-the-baseline
    and too-close criterion marks."""
    rng = np.random.default_rng(seed)
    n_shell = int(n * 0.5)
    n_torus = int(n * 0.35)
    n_core = n - n_shell - n_torus - 8

    # sphere shell r=0.8, checkerboard colour in spherical coords
    u = rng.uniform(-1.0, 1.0, n_shell)
    th = rng.uniform(0, 2 * math.pi, n_shell)
    sq = np.sqrt(1 - u * u)
    shell = 0.8 * np.stack([sq * np.cos(th), sq * np.sin(th), u], axis=1)
    check = ((np.floor(th / (2 * math.pi) * 16)
              + np.floor((u + 1) * 8)) % 2)
    shell_col = np.stack([0.85 * check + 0.1,
                          0.85 * (1 - check) + 0.1,
                          0.25 + 0.5 * (np.sin(3 * th) * 0.5 + 0.5)],
                         axis=1)

    # torus R=1.4 r=0.22, azimuthal stripes
    a = rng.uniform(0, 2 * math.pi, n_torus)
    b = rng.uniform(0, 2 * math.pi, n_torus)
    torus = np.stack([(1.4 + 0.22 * np.cos(b)) * np.cos(a),
                      0.22 * np.sin(b),
                      (1.4 + 0.22 * np.cos(b)) * np.sin(a)], axis=1)
    stripe = (np.floor(a / (2 * math.pi) * 24) % 2)
    torus_col = np.stack([0.2 + 0.7 * stripe,
                          0.3 + 0.4 * (np.cos(5 * b) * 0.5 + 0.5),
                          0.9 - 0.7 * stripe], axis=1)

    core = rng.normal(size=(n_core, 3)) * 0.12
    core_col = rng.uniform(0.15, 0.95, size=(n_core, 3))

    od = rng.normal(size=(8, 3))
    od /= np.linalg.norm(od, axis=1, keepdims=True)
    outl = od * rng.uniform(3.4, 4.2, size=(8, 1))
    outl_col = rng.uniform(0.3, 0.8, size=(8, 3))

    # the bead string, within voxel_size of the chords between
    # consecutive arc stations and < 0.5 from those cameras
    n_beads = 64
    tb = rng.uniform(0.0, ARC_DTH * (ARC_STATIONS - 1), n_beads)
    rb = ARC_R * (1.0 - rng.uniform(0.0, 0.004, n_beads))
    yb = (ARC_Y0 + ARC_DY * (tb / ARC_DTH)
          + rng.uniform(-0.003, 0.003, n_beads))
    beads = np.stack([rb * np.cos(ARC_TH0 + tb), yb,
                      rb * np.sin(ARC_TH0 + tb)], axis=1)
    bead_col = np.stack([0.9 * np.ones(n_beads),
                         rng.uniform(0.1, 0.9, n_beads),
                         0.1 * np.ones(n_beads)], axis=1)

    pts = np.concatenate([shell, torus, core, outl, beads]
                         ).astype(np.float32)
    cols = np.concatenate([shell_col, torus_col, core_col, outl_col,
                           bead_col]).astype(np.float32)
    return pts, cols


def hard_camera(i: int, total: int, width: int, height_px: int,
                fovx: float = 1.0, arc_period: int = 3,
                device=None) -> Camera:
    """View i of the hard rig: every `arc_period`-th view (i % P == P-1)
    on the tight inner arc (radius ARC_R, ARC_DTH steps) looking through
    the core, whose pairs pass CVPM's SSIM gate and whose baselines cross
    the bead string; the rest orbit at radius 3 for coverage.  P = 2
    doubles the arc's share for short runs."""
    n_arc = total // arc_period
    if i % arc_period == arc_period - 1:
        k = i // arc_period
        th = ARC_TH0 + ARC_DTH * k
        eye = [ARC_R * math.cos(th), ARC_Y0 + ARC_DY * k,
               ARC_R * math.sin(th)]
        return look_at_camera(eye, [0, 0, 0], [0, -1, 0], fovx,
                              fovx * height_px / width, width, height_px,
                              uid=i, device=device)
    j = i - i // arc_period - (1 if i % arc_period == arc_period - 1
                               else 0)
    th = 2 * math.pi * j / max(total - n_arc, 1)
    eye = [3.0 * math.cos(th), 0.7 * math.sin(2.3 * th), 3.0 * math.sin(th)]
    return look_at_camera(eye, [0, 0, 0], [0, -1, 0], fovx,
                          fovx * height_px / width, width, height_px, uid=i,
                          device=device)


def write_hard_dataset(path: str, n_views: int = 30, n_pts: int = 3500,
                       width: int = 320, height: int = 224,
                       seed: int = 0, init_frac: float = 0.12,
                       n_junk: int = 40, arc_period: int = 3,
                       device=None) -> None:
    """The hard protocol's Blender scene: make_hard_cloud's content
    rendered (gaussians of scale 0.012) from the hard rig, and a SPARSE
    noisy init: init_frac of the points displaced, n_junk spurious far
    points and the bead string.  The images are rendered on `device`
    (None: the card)."""
    dev = resolve_device(device)
    os.makedirs(path, exist_ok=True)
    pts, colors = make_hard_cloud(n_pts, seed)
    fovx = 1.0

    def dump(split: str, idxs):
        frames = []
        for i in idxs:
            cam = hard_camera(i, n_views, width, height, fovx,
                              arc_period=arc_period, device=dev)
            fname = f"r_{i}"
            save_png(os.path.join(path, split, fname + ".png"),
                     render_gt(pts, colors, cam, scale=0.012))
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
    keep = rng.choice(n_pts, size=max(int(n_pts * init_frac), 16),
                      replace=False)
    noisy = (pts[keep]
             + rng.normal(size=(keep.size, 3)).astype(np.float32) * 0.04)
    jd = rng.normal(size=(n_junk, 3)).astype(np.float32)
    jd /= np.linalg.norm(jd, axis=1, keepdims=True)
    junk = jd * rng.uniform(3.2, 4.0, size=(n_junk, 1)).astype(np.float32)
    # the bead string (the cloud's last 64 points) always seeds init
    # anchors, so CVPM's candidates exist from iteration 1
    beads = (pts[-64:]
             + rng.normal(size=(64, 3)).astype(np.float32) * 0.005)
    init_pts = np.concatenate([noisy, junk, beads])
    init_col = np.concatenate([colors[keep],
                               rng.uniform(0.2, 0.8, size=(n_junk, 3))
                               .astype(np.float32), colors[-64:]])
    store_point_cloud(os.path.join(path, "points3d.ply"), init_pts,
                      init_col * 255)


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
