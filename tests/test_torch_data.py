"""The port's data layer (splatco_torch/data, utils/synthetic.py, the PLY
writer) against splatco_tpu on the CPU, on scenes the JAX writers produce
(96x64, 10 views).

Everything here is exact: the readers field by field, the files the two
packages write byte for byte, the images bit for bit (the bicubic resize
reproduces PIL's fixed-point arithmetic; the bound the port is held to at
-r 2 is one 8-bit level with at least 99 % of pixels equal), and the PNG
decoder equal to PIL on every colour type and filter type.
"""
import filecmp
import os
import random
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from splatco_torch.config import ModelConfig
from splatco_torch.data import colmap, images, native_io, readers
from splatco_torch.data.ply import write_ply
from splatco_torch.data.scene import Scene
from splatco_torch.utils import synthetic
from splatco_tpu.config import ModelConfig as JModelConfig
from splatco_tpu.data import colmap as j_colmap
from splatco_tpu.data import readers as j_readers
from splatco_tpu.data.ply import write_ply as j_write_ply
from splatco_tpu.data.scene import Scene as JScene
from splatco_tpu.utils import synthetic as j_synthetic

W, H, VIEWS = 96, 64, 10
SPARSE = os.path.join("sparse", "0")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX writers' COLMAP and Blender scenes."""
    root = tmp_path_factory.mktemp("scenes")
    j_synthetic.write_colmap_dataset(str(root / "colmap"), n_views=VIEWS,
                                     width=W, height=H)
    j_synthetic.write_blender_dataset(str(root / "blender"), n_views=VIEWS,
                                      width=W, height=H)
    return root


def copy_scene(src, dst, drop=()):
    """A copy of scene `src` without the files `drop` (where present: a
    reader writes the COLMAP points3D.ply on first read)."""
    shutil.copytree(src, dst)
    for rel in drop:
        if os.path.exists(os.path.join(dst, rel)):
            os.remove(os.path.join(dst, rel))
    return str(dst)


def write_text_model(sparse: str) -> None:
    """cameras.txt / images.txt / points3D.txt of the binary model."""
    cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, err = colmap.read_points3d_binary(
        os.path.join(sparse, "points3D.bin"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("# camera list\n")
        for c in cams.values():
            fh.write(f"{c.id} {c.model} {c.width} {c.height} "
                     + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        for im in imgs.values():
            fh.write(" ".join([str(im.id), *map(repr, map(float, im.qvec)),
                               *map(repr, map(float, im.tvec)),
                               str(im.camera_id), im.name])
                     + "\n1.5 2.5 -1\n")  # the parsers skip blank lines
    with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
        for i in range(len(xyz)):
            fh.write(" ".join([str(i + 1), *map(repr, map(float, xyz[i])),
                               *map(str, rgb[i]), repr(float(err[i, 0]))])
                     + "\n")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        os.remove(os.path.join(sparse, name))


def assert_scene_info_equal(got, want, roots):
    """Field by field; paths relative to the scene roots (port, jax)."""
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.nerf_normalization["radius"] == \
        want.nerf_normalization["radius"]
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    for split in ("train_cameras", "test_cameras"):
        a, b = getattr(got, split), getattr(want, split)
        assert len(a) == len(b)
        for ca, cb in zip(a, b):
            assert ca._fields == cb._fields
            for f in ca._fields:
                x, y = getattr(ca, f), getattr(cb, f)
                if f == "image_path":
                    x, y = (os.path.relpath(v, r) for v, r in
                            zip((x, y), roots))
                if isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, f)
                else:
                    assert x == y, f
    assert filecmp.cmp(got.ply_path, want.ply_path, shallow=False)


@pytest.mark.parametrize("form", ["binary", "text"])
def test_read_colmap_scene_matches_jax(scenes, tmp_path, form):
    """Each package converts the points to PLY itself, from the native
    parser (binary) or the text parser."""
    drop = [os.path.join(SPARSE, "points3D.ply")]
    paths = [copy_scene(scenes / "colmap", tmp_path / side, drop)
             for side in ("port", "jax")]
    if form == "text":
        for p in paths:
            write_text_model(os.path.join(p, SPARSE))
    for split in (True, False):
        got = readers.read_colmap_scene(paths[0], eval_split=split)
        want = j_readers.read_colmap_scene(paths[1], eval_split=split)
        assert_scene_info_equal(got, want, paths)
        assert len(got.test_cameras) == (2 if split else 0)
    assert [c.image_name for c in got.train_cameras] == sorted(
        f"frame_{i:04d}" for i in range(VIEWS))


def test_read_blender_scene_matches_jax(scenes, tmp_path):
    """Without points3d.ply both readers draw the same random cloud from
    the seeded global numpy RNG."""
    paths = [copy_scene(scenes / "blender", tmp_path / side,
                        ["points3d.ply"]) for side in ("port", "jax")]
    np.random.seed(5)
    got = readers.read_blender_scene(paths[0], white_background=False)
    np.random.seed(5)
    want = j_readers.read_blender_scene(paths[1], white_background=False)
    assert_scene_info_equal(got, want, paths)
    assert len(got.points) == 100_000
    got = readers.read_blender_scene(paths[0], eval_split=False)
    want = j_readers.read_blender_scene(paths[1], eval_split=False)
    assert_scene_info_equal(got, want, paths)


@pytest.mark.parametrize("kind", ["colmap", "blender"])
@pytest.mark.parametrize("resolution", [-1, 2])
def test_load_camera_matches_jax(scenes, kind, resolution):
    read = {"colmap": (readers.read_colmap_scene,
                       j_readers.read_colmap_scene),
            "blender": (readers.read_blender_scene,
                        j_readers.read_blender_scene)}[kind]
    infos = read[1](str(scenes / kind)).train_cameras[:3]
    for uid, info in enumerate(infos):
        got = readers.load_camera(info, uid, resolution, device="cpu")
        want = j_readers.load_camera(info, uid, resolution)
        a, b = got.image.numpy(), np.asarray(want.image)
        scale = 1 if resolution == -1 else resolution
        assert a.shape == b.shape == (3, H // scale, W // scale)
        if resolution == -1:
            np.testing.assert_array_equal(a, b)
        else:
            levels = np.abs(np.round(a * 255) - np.round(b * 255))
            assert levels.max() <= 1 and (levels == 0).mean() >= 0.99
        for f in ("world_view_transform", "full_proj_transform",
                  "camera_center", "R", "T"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
        assert (got.fovx, got.fovy, got.image_name) == (
            want.fovx, want.fovy, want.image_name)


@pytest.mark.parametrize("kind", ["colmap", "blender"])
def test_scene_matches_jax(scenes, tmp_path, kind):
    """The shuffled split (Python's global RNG), cameras.json, input.ply,
    the extent and the scene box."""
    out = {}
    for side, cls, cfg_cls in (("port", Scene, ModelConfig),
                               ("jax", JScene, JModelConfig)):
        cfg = cfg_cls(source_path=str(scenes / kind),
                      model_path=str(tmp_path / side))
        random.seed(11)
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = cls(cfg, shuffle=True, load_images=False, **kw)
    port, jax_ = out["port"], out["jax"]
    for name in ("cameras.json", "input.ply"):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    assert port.cameras_extent == jax_.cameras_extent
    for fn in ("train_cameras", "test_cameras"):
        a, b = getattr(port, fn)(), getattr(jax_, fn)()
        assert [(c.image_name, c.uid) for c in a] == [
            (c.image_name, int(c.uid)) for c in b]
    assert port.scene_bbox() == jax_.scene_bbox()
    np.testing.assert_array_equal(port.points, jax_.points)


def write_colmap_binaries(tmp_path, seed=0):
    """images.bin with 2D points and points3D.bin with tracks."""
    rng = np.random.default_rng(seed)
    p3d = tmp_path / "points3D.bin"
    with open(p3d, "wb") as fh:
        fh.write(struct.pack("<Q", 300))
        for i in range(300):
            fh.write(struct.pack("<QdddBBBd", i, *rng.normal(size=3),
                                 *rng.integers(0, 256, 3), rng.uniform()))
            track = int(rng.integers(0, 5))
            fh.write(struct.pack("<Q", track) + b"\1" * (8 * track))
    imgs = tmp_path / "images.bin"
    with open(imgs, "wb") as fh:
        fh.write(struct.pack("<Q", 5))
        for i in range(5):
            fh.write(struct.pack("<idddddddi", i + 3, *rng.normal(size=7),
                                 2))
            fh.write(f"view_{i}.jpg".encode() + b"\0")
            n = int(rng.integers(0, 6))
            fh.write(struct.pack("<Q", n))
            for j in range(n):
                fh.write(struct.pack("<ddq", *rng.normal(size=2), j - 1))
    return str(p3d), str(imgs)


def test_native_parser_matches_numpy(tmp_path):
    p3d, imgs = write_colmap_binaries(tmp_path)
    got = native_io.read_points3d(p3d)
    for want in (colmap.read_points3d_binary(p3d),
                 j_colmap.read_points3d_binary(p3d)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got = native_io.read_images(imgs)
    want = j_colmap.read_images_binary(imgs)
    assert list(got) == list(want) == [3, 4, 5, 6, 7]
    for k in want:
        for f in want[k]._fields:
            np.testing.assert_array_equal(getattr(got[k], f),
                                          getattr(want[k], f), f)
    with open(imgs, "rb") as fh:
        data = fh.read()
    with open(imgs, "wb") as fh:  # cut inside the last record
        fh.write(data[:-5])
    with pytest.raises(ValueError, match="images.bin"):
        native_io.read_images(imgs)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises; nothing falls back to the numpy parsers."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_io, "CXX_FLAGS",
                        native_io.CXX_FLAGS + ("-no-such-flag",))
    p3d, _ = write_colmap_binaries(tmp_path)
    with pytest.raises(RuntimeError, match="splatco_io.cpp"):
        native_io.read_points3d(p3d)
    assert native_io._lib is None


def test_native_library_is_built_from_source():
    path = native_io.library_path()
    assert path.parent == native_io.BUILD_DIR
    assert path.parent.name == "_build"
    assert "-march" not in " ".join(native_io.CXX_FLAGS)
    native_io.build()
    assert path.exists()


def test_write_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    cols = {"x": rng.normal(size=50).astype(np.float32),
            "d": rng.normal(size=50),
            "i": rng.integers(-9, 9, 50).astype(np.int32),
            "u": rng.integers(0, 255, 50).astype(np.uint8),
            "s": rng.integers(0, 9, 50).astype(np.uint16)}
    write_ply(str(tmp_path / "port.ply"), cols)
    j_write_ply(str(tmp_path / "jax.ply"), cols)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_synthetic_files_match_jax(scenes, tmp_path):
    """The port's writers (ground truth rendered on the CPU) write the
    JAX writers' camera and point files byte for byte."""
    synthetic.write_colmap_dataset(str(tmp_path / "colmap"), n_views=VIEWS,
                                   width=W, height=H, device="cpu")
    synthetic.write_blender_dataset(str(tmp_path / "blender"),
                                    n_views=VIEWS, width=W, height=H,
                                    device="cpu")
    files = [os.path.join("colmap", SPARSE, f) for f in
             ("cameras.bin", "images.bin", "points3D.bin")]
    files += [os.path.join("blender", f) for f in
              ("transforms_train.json", "transforms_test.json",
               "points3d.ply")]
    for rel in files:
        assert filecmp.cmp(tmp_path / rel, scenes / rel, shallow=False), rel
    # the images: the same views of the same cloud (binned blend vs the
    # JAX dense oracle)
    for rel in (os.path.join("colmap", "images", "frame_0003.png"),
                os.path.join("blender", "test", "r_4.png")):
        a = np.asarray(Image.open(tmp_path / rel), np.int16)
        b = np.asarray(Image.open(scenes / rel), np.int16)
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1 and a.std() > 0


def png_with_filters(arr: np.ndarray, ftypes) -> bytes:
    """An 8-bit PNG of [H, W, C] `arr` whose row y uses filter
    ftypes[y % len(ftypes)], encoded per the PNG specification."""
    h, w, c = arr.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    x = arr.reshape(h, w * c).astype(np.int64)
    body = b""
    for y in range(h):
        t = ftypes[y % len(ftypes)]
        prev = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if t == 0:
            pred = np.zeros_like(x[y])
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        body += bytes([t]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (images.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4],
                                    [0, 1, 2, 3, 4], [2, 1]])
def test_png_filters_decode_as_pil(tmp_path, channels, ftypes):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(png_with_filters(arr, ftypes))
    got = images.read_image(str(path))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(
        got.reshape(np.asarray(Image.open(path)).shape),
        np.asarray(Image.open(path)))
    assert images.image_size(str(path)) == (17, 13)


def test_truncated_png_raises(tmp_path):
    path = tmp_path / "cut.png"
    images.save_png(str(path), np.full((3, 10, 12), 0.5, np.float32))
    data = path.read_bytes()
    for cut in (20, 30, len(data) - 13, len(data) - 5):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="cut.png"):
            images.read_image(str(path))
    path.write_bytes(data[:20])
    with pytest.raises(ValueError, match="cut.png"):
        images.image_size(str(path))


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       channels=st.sampled_from([1, 3, 4]), seed=st.integers(0, 2 ** 16),
       writer=st.sampled_from(["pil", "cv2"]),
       smooth=st.booleans())
def test_png_decoder_matches_pil(tmp_path_factory, h, w, channels, seed,
                                 writer, smooth):
    """Random small images written by PIL or OpenCV (each picks its own
    filters) decode to PIL's pixels."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if smooth:  # gradients, where the encoders prefer Sub/Up/Avg/Paeth
        arr = np.cumsum(arr // 16, axis=1, dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("png") / "x.png")
    if writer == "pil":
        Image.fromarray(arr[..., 0] if channels == 1 else arr).save(path)
    else:
        bgr = arr[..., {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[channels]]
        assert cv2.imwrite(path, np.ascontiguousarray(bgr))
    got = images.read_image(path)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("size", [(48, 32), (8, 5), (250, 70), (96, 13),
                                  (96, 64), (40, 64)])
def test_resize_bicubic_matches_pil(mode, size):
    rng = np.random.default_rng(len(mode))
    arr = rng.integers(0, 256, (64, 96, len(mode)), dtype=np.uint8)
    arr = np.cumsum(arr // 8, axis=0, dtype=np.uint8)
    im = Image.fromarray(arr[..., 0] if mode == "L" else arr)
    want = np.asarray(im.resize(size, Image.Resampling.BICUBIC))
    got = images.resize_bicubic(arr, *size)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_jpeg_without_pil_raises(tmp_path, monkeypatch):
    path = tmp_path / "view.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    got = images.read_image(str(path))  # through PIL
    assert got.shape == (4, 4, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="view.jpg"):
        images.read_image(str(path))
    with pytest.raises(RuntimeError, match="view.jpg"):
        images.image_size(str(path))


def test_blender_composite_matches_jax_formula():
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (7, 9, 4), dtype=np.uint8)
    for white in (True, False):
        f = np.asarray(Image.fromarray(rgba).convert("RGBA")
                       ).astype(np.float32) / 255.0
        bg = 1.0 if white else 0.0
        want = ((f[..., :3] * f[..., 3:] + bg * (1 - f[..., 3:])) * 255
                ).astype(np.uint8)
        np.testing.assert_array_equal(images.composite_rgba(rgba, white),
                                      want)
    grey = rgba[..., :1]
    np.testing.assert_array_equal(images.composite_rgba(grey, True),
                                  np.repeat(grey, 3, axis=2))
