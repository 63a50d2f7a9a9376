"""COLMAP reconstruction parsers (binary + text): this package's own copy
of splatco_tpu/data/colmap.py, numpy only.

cameras.bin / images.bin / points3D.bin and their .txt variants, written
against the documented COLMAP on-disk format.  The readers take the
binary images and points through the native parser (data/native_io.py);
these parsers serve the cameras and the text files, and are the
reference the native parser is tested against.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R):
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fh, n, fmt):
    return struct.unpack("<" + fmt, fh.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(fh, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            cams[cid] = ColmapCamera(cid, el[1], int(el[2]), int(el[3]),
                                     np.array(el[4:], dtype=np.float64))
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, 8, "Q")
        for _ in range(num):
            iid = _read(fh, 4, "i")[0]
            qvec = np.array(_read(fh, 32, "dddd"))
            tvec = np.array(_read(fh, 24, "ddd"))
            cam_id = _read(fh, 4, "i")[0]
            name = b""
            ch = fh.read(1)
            while ch != b"\x00":
                name += ch
                ch = fh.read(1)
            (n_pts,) = _read(fh, 8, "Q")
            rec = np.frombuffer(
                fh.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            xys = np.stack([rec["x"], rec["y"]], axis=1)
            ids = rec["id"].astype(np.int64)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids)
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as fh:
        lines = [ln.strip() for ln in fh
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(pts, dtype=np.float64).reshape(-1, 3)
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                  arr[:, :2], arr[:, 2].astype(np.int64))
    return images


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, errors [N,1] f64)."""
    with open(path, "rb") as fh:
        (num,) = _read(fh, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num, 1))
        for i in range(num):
            data = _read(fh, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(fh, 8, "Q")
            fh.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz_l.append([float(x) for x in el[1:4]])
            rgb_l.append([int(x) for x in el[4:7]])
            err_l.append([float(el[7])])
    return (np.array(xyz_l), np.array(rgb_l, dtype=np.uint8),
            np.array(err_l))
