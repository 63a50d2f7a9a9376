"""Scene dataset readers: COLMAP and Blender (NeRF-synthetic), the
counterpart of splatco_tpu/data/readers.py.

Same camera lists, split (llffhold = 8 over the name-sorted views),
intrinsics (PINHOLE / SIMPLE_PINHOLE), NeRF++ normalization, point-cloud
conversion and resolution policy (-1 = cap the width at 1600 px).  The
binary COLMAP images and points go through the native parser
(data/native_io.py), the text files through data/colmap.py, and the
image files through data/images.py instead of PIL.
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional

import numpy as np

from splatco_torch.data import colmap, native_io
from splatco_torch.data.cameras import (Camera, focal2fov, fov2focal,
                                        make_camera)
from splatco_torch.data.images import (composite_rgba, image_size,
                                       read_image, resize_bicubic, to_rgb)
from splatco_torch.data.ply import fetch_point_cloud, store_point_cloud
from splatco_torch.ops.sh import sh_to_rgb
from splatco_torch.utils.device import resolve_device


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovy: float
    fovx: float
    image_path: str
    image_name: str
    width: int
    height: int
    blender_white_bg: Optional[bool] = None  # None = plain RGB load


class SceneInfo(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = []
    for cam in cam_infos:
        rt = np.zeros((4, 4))
        rt[:3, :3] = cam.R.transpose()
        rt[:3, 3] = cam.T
        rt[3, 3] = 1.0
        centers.append(np.linalg.inv(rt)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=0))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = True, llffhold: int = 8
                      ) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = native_io.read_images(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        r = np.transpose(colmap.qvec2rotmat(im.qvec))
        t = np.array(im.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(cam.params[0], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        elif cam.model == "PINHOLE":
            fovy = focal2fov(cam.params[1], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; run "
                "convert.py to undistort")
        image_path = os.path.join(path, images_dir,
                                  os.path.basename(im.name))
        infos.append(CameraInfo(
            uid=cam.id, R=r, T=t, fovy=fovy, fovx=fovx,
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=cam.width, height=cam.height))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        if os.path.exists(os.path.join(sparse, "points3D.bin")):
            xyz, rgb, _ = native_io.read_points3d(
                os.path.join(sparse, "points3D.bin"))
        else:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)
    points, colors, _ = fetch_point_cloud(ply_path)

    return SceneInfo(points=points, colors=colors, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=nerfpp_norm(train),
                     ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool = True,
                       eval_split: bool = True, extension: str = ".png"
                       ) -> SceneInfo:
    def read_transforms(fname):
        with open(os.path.join(path, fname)) as fh:
            contents = json.load(fh)
        fovx = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            img_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            r = np.transpose(w2c[:3, :3])
            t = w2c[:3, 3]
            w, h = image_size(img_path)
            fovy = focal2fov(fov2focal(fovx, w), h)
            infos.append(CameraInfo(
                uid=idx, R=r, T=t, fovy=fovy, fovx=fovx,
                image_path=img_path,
                image_name=os.path.splitext(os.path.basename(img_path))[0],
                width=w, height=h, blender_white_bg=white_background))
        return infos

    train = read_transforms("transforms_train.json")
    test = read_transforms("transforms_test.json")
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # the global numpy RNG, as the JAX reader draws it: with
        # np.random.seed set, both packages write the same cloud
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    points, colors, _ = fetch_point_cloud(ply_path)
    return SceneInfo(points=points, colors=colors, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=nerfpp_norm(train),
                     ply_path=ply_path)


def target_resolution(orig_w: int, orig_h: int, resolution: int,
                      resolution_scale: float = 1.0):
    """The reference loader's resolution policy: 1/2/4/8 divide, -1 caps
    the width at 1600 px, any other value is the target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(info: CameraInfo, uid: int, resolution: int = -1,
                resolution_scale: float = 1.0, with_image: bool = True,
                device=None) -> Camera:
    """The view on `device` (None: the card), with its image resized as
    the JAX reader's PIL calls resize it.  An RGBA image outside a Blender
    scene loses its alpha before the resize, where PIL resizes it
    premultiplied: the two differ only where alpha < 255 and the size
    changes."""
    dev = resolve_device(device)
    image = None
    if with_image:
        arr = read_image(info.image_path)
        w, h = target_resolution(arr.shape[1], arr.shape[0], resolution,
                                 resolution_scale)
        if info.blender_white_bg is not None:
            arr = composite_rgba(arr, info.blender_white_bg)
        arr = resize_bicubic(to_rgb(arr), w, h)
        image = (arr.astype(np.float32) / 255.0).transpose(2, 0, 1)
    else:
        w, h = target_resolution(info.width, info.height, resolution,
                                 resolution_scale)
    return make_camera(info.R, info.T, info.fovx, info.fovy, image, w, h,
                       uid=uid, image_name=info.image_name, device=dev)
