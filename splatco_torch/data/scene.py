"""Scene orchestration (counterpart of splatco_tpu/data/scene.py): dataset
detection, train/test camera lists, the cameras.json / input.ply
artifacts, and the NeRF++ radius used as the spatial learning-rate
scale."""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

import numpy as np

from splatco_torch.config import ModelConfig
from splatco_torch.data.cameras import Camera, fov2focal
from splatco_torch.data.readers import (CameraInfo, SceneInfo, load_camera,
                                        read_blender_scene, read_colmap_scene)
from splatco_torch.utils.device import resolve_device


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    rt = np.zeros((4, 4))
    rt[:3, :3] = info.R.transpose()
    rt[:3, 3] = info.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [row.tolist() for row in w2c[:3, :3]],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }


class Scene:
    """A COLMAP or Blender scene at `cfg.source_path`, its cameras loaded
    on first use onto `device` (None: the card).  `shuffle` shuffles the
    camera lists with the Python global RNG, as the JAX Scene does."""

    def __init__(self, cfg: ModelConfig, shuffle: bool = True,
                 load_images: bool = True, write_artifacts: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        src = cfg.source_path
        if os.path.exists(os.path.join(src, "sparse")):
            info = read_colmap_scene(src, cfg.images, cfg.eval)
        elif os.path.exists(os.path.join(src, "transforms_train.json")):
            info = read_blender_scene(src, cfg.white_background, cfg.eval)
        else:
            raise ValueError(f"Could not recognize scene type at {src}")
        self.info: SceneInfo = info
        self.cameras_extent = float(info.nerf_normalization["radius"])

        if write_artifacts and cfg.model_path:
            os.makedirs(cfg.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path,
                            os.path.join(cfg.model_path, "input.ply"))
            cams = [camera_to_json(i, c) for i, c in enumerate(
                list(info.test_cameras) + list(info.train_cameras))]
            with open(os.path.join(cfg.model_path, "cameras.json"),
                      "w") as fh:
                json.dump(cams, fh)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            random.shuffle(train_infos)
            random.shuffle(test_infos)
        self._train_infos = train_infos
        self._test_infos = test_infos
        self._load_images = load_images
        self._train_cache: Optional[List[Camera]] = None
        self._test_cache: Optional[List[Camera]] = None

    @property
    def points(self) -> np.ndarray:
        return self.info.points

    def train_cameras(self) -> List[Camera]:
        if self._train_cache is None:
            self._train_cache = [
                load_camera(c, uid=i, resolution=self.cfg.resolution,
                            with_image=self._load_images, device=self.device)
                for i, c in enumerate(self._train_infos)]
        return self._train_cache

    def test_cameras(self) -> List[Camera]:
        if self._test_cache is None:
            base = len(self._train_infos)
            self._test_cache = [
                load_camera(c, uid=base + i, resolution=self.cfg.resolution,
                            with_image=self._load_images, device=self.device)
                for i, c in enumerate(self._test_infos)]
        return self._test_cache

    def scene_bbox(self):
        """Centre and (isotropic) length of the train camera centres."""
        cams = self.train_cameras()
        pos = np.stack([c.camera_center.cpu().numpy() for c in cams])
        center = pos.mean(axis=0)
        length = float(pos.max() - pos.min())
        return center.tolist(), [length] * 3
