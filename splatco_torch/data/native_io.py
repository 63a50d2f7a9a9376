"""ctypes bindings for the native COLMAP parsers (native/splatco_io.cpp),
the counterpart of splatco_tpu/data/native_io.py.

The library is built from the repository's source at first use into
`splatco_torch/_build/` (gitignored), under a name that hashes the source
and the flags.  The flags tune for no particular CPU (no -march=native):
a build directory may travel with the tree to another machine.  There is
no fallback: when the build fails, the first read raises.
`read_points3d` / `read_images` return what colmap.py's binary parsers
return.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from splatco_torch.data.colmap import ColmapImage

SOURCE = Path(__file__).resolve().parents[2] / "native" / "splatco_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
# bytes of the smallest record: points3D.bin's id, xyz, rgb, error and
# track length; images.bin's id, qvec, tvec, camera id, name's NUL and
# point count
POINT_RECORD_MIN = 8 + 24 + 3 + 8 + 8
IMAGE_RECORD_MIN = 4 + 32 + 24 + 4 + 1 + 8

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsplatco_io-{digest[:16]}.so"


def _compiler() -> str:
    for name in ("g++", "c++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: the native COLMAP parser "
                       f"({SOURCE}) cannot be built")


def build() -> Path:
    """Compile the library if it is missing; raises if the compile
    fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_f64p = ctypes.POINTER(ctypes.c_double)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        lib.splatco_points3d_count.argtypes = [c_u8p, ctypes.c_int64, c_i64p]
        lib.splatco_points3d_parse.argtypes = [c_u8p, ctypes.c_int64, c_f64p,
                                               c_u8p, c_f64p]
        lib.splatco_images_count.argtypes = [c_u8p, ctypes.c_int64, c_i64p,
                                             c_i64p, c_i64p]
        lib.splatco_images_parse.argtypes = [
            c_u8p, ctypes.c_int64, c_i32p, c_f64p, c_f64p, c_i32p, c_i64p,
            ctypes.c_char_p, c_i64p, c_f64p, c_i64p]
        for fn in (lib.splatco_points3d_count, lib.splatco_points3d_parse,
                   lib.splatco_images_count, lib.splatco_images_parse):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check(rc: int, what: str, path: str) -> None:
    if rc != 0:
        raise ValueError(f"{path}: {what} failed with {rc} (truncated or "
                         "not a COLMAP binary file)")


def read_points3d(path: str):
    """points3D.bin -> (xyz [N,3] f64, rgb [N,3] u8, errors [N,1] f64)."""
    lib = _load()
    data = np.fromfile(path, dtype=np.uint8)
    n = ctypes.c_int64()
    _check(lib.splatco_points3d_count(_ptr(data, ctypes.c_uint8), data.size,
                                      ctypes.byref(n)), "count", path)
    if not 0 <= n.value <= (data.size - 8) // POINT_RECORD_MIN:
        raise ValueError(f"{path}: {n.value} points do not fit in "
                         f"{data.size} bytes")
    xyz = np.empty((n.value, 3), np.float64)
    rgb = np.empty((n.value, 3), np.uint8)
    err = np.empty((n.value, 1), np.float64)
    _check(lib.splatco_points3d_parse(
        _ptr(data, ctypes.c_uint8), data.size, _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_uint8), _ptr(err, ctypes.c_double)), "parse", path)
    return xyz, rgb, err


def read_images(path: str) -> Dict[int, ColmapImage]:
    """images.bin -> {image_id: ColmapImage}."""
    lib = _load()
    data = np.fromfile(path, dtype=np.uint8)
    n = ctypes.c_int64()
    name_bytes = ctypes.c_int64()
    total_pts = ctypes.c_int64()
    _check(lib.splatco_images_count(_ptr(data, ctypes.c_uint8), data.size,
                                    ctypes.byref(n), ctypes.byref(name_bytes),
                                    ctypes.byref(total_pts)), "count", path)
    nv = n.value
    if not (0 <= nv <= (data.size - 8) // IMAGE_RECORD_MIN
            and 0 <= total_pts.value <= data.size // 24):
        raise ValueError(f"{path}: {nv} images with {total_pts.value} "
                         f"points do not fit in {data.size} bytes")
    image_id = np.empty(nv, np.int32)
    qvec = np.empty((nv, 4), np.float64)
    tvec = np.empty((nv, 3), np.float64)
    camera_id = np.empty(nv, np.int32)
    name_off = np.empty(nv + 1, np.int64)
    names = ctypes.create_string_buffer(max(name_bytes.value, 1))
    pts_off = np.empty(nv + 1, np.int64)
    xys = np.empty((total_pts.value, 2), np.float64)
    p3d = np.empty(total_pts.value, np.int64)
    _check(lib.splatco_images_parse(
        _ptr(data, ctypes.c_uint8), data.size, _ptr(image_id, ctypes.c_int32),
        _ptr(qvec, ctypes.c_double), _ptr(tvec, ctypes.c_double),
        _ptr(camera_id, ctypes.c_int32), _ptr(name_off, ctypes.c_int64),
        names, _ptr(pts_off, ctypes.c_int64), _ptr(xys, ctypes.c_double),
        _ptr(p3d, ctypes.c_int64)), "parse", path)
    raw_names = names.raw
    out = {}
    for i in range(nv):
        nm = raw_names[name_off[i]:name_off[i + 1]].decode("utf-8")
        sl = slice(pts_off[i], pts_off[i + 1])
        out[int(image_id[i])] = ColmapImage(
            int(image_id[i]), qvec[i].copy(), tvec[i].copy(),
            int(camera_id[i]), nm, xys[sl].copy(), p3d[sl].copy())
    return out
