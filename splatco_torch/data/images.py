"""Image files without Pillow: the port's stand-in for the PIL calls of
splatco_tpu/data/readers.py and of the JAX PNG writers.

  * PNG is decoded and written with the standard library (`zlib`):
    8-bit grey, RGB and RGBA, not interlaced, filters 0-4,
  * JPEG (and any other format) goes through PIL where PIL imports, and
    raises, naming the file, where it does not,
  * `resize_bicubic` repeats PIL's `Image.resize(..., BICUBIC)` on 8-bit
    images: the same filter (a = -0.5, support widened by the downscale
    factor), the same 22-bit fixed-point weights and the same two passes
    (horizontal, then vertical, each rounded to 8 bits), and the pixels
    unchanged at the same size,
  * `composite_rgba` is the Blender reader's alpha composite over the
    background, in float32 as the JAX reader computes it.
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels of the 8-bit types decoded here
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
# PIL's fixed-point precision for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0


def _png_chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        end = pos + 12 + length
        tag, body = data[pos + 4:pos + 8], data[pos + 8:end - 4]
        if end > len(data) or zlib.crc32(tag + body) != struct.unpack(
                ">I", data[end - 4:end])[0]:
            raise ValueError(f"{path}: truncated or corrupt {tag!r} chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: no IEND chunk")


def _png_header(body: bytes, path: str) -> Tuple[int, int, int]:
    if len(body) != 13:
        raise ValueError(f"{path}: an IHDR chunk of {len(body)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} is not supported (8-bit grey, RGB or "
            "RGBA, not interlaced)")
    return w, h, _PNG_CHANNELS[ctype]


def _unfilter_rows(ftype: np.ndarray, filt: np.ndarray, bpp: int
                   ) -> np.ndarray:
    """Rows whose filters are None, Sub or Up: one vector step a row."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        t = ftype[y]
        if t == 0:
            out[y] = filt[y]
        elif t == 1:  # Sub: a running sum of each channel, mod 256
            out[y] = np.cumsum(filt[y].reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:  # Up
            out[y] = filt[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(ftype: np.ndarray, filt: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """Any filters (Average and Paeth included).  A pixel depends on its
    left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal (x + y = d) are independent: one vector step a
    diagonal."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int16)
    r = np.zeros((h + 1, w + 1, bpp), np.int16)  # row 0, column 0: zeros
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = r[ys + 1, xs]      # left
        b = r[ys, xs + 1]      # up
        c = r[ys, xs]          # up-left
        t = ftype[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        r[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return r[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(path: str) -> np.ndarray:
    """[H, W, C] uint8, C = 1 (grey), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for tag, body in _png_chunks(data, path):
        if tag == b"IHDR":
            header = _png_header(body, path)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, bpp = header
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    if len(raw) != h * (1 + stride):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data for a "
                         f"{w}x{h}x{bpp} image")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG filter type {ftype.max()}")
    if ftype.max(initial=0) <= 2:
        out = _unfilter_rows(ftype, filt, bpp)
    else:
        out = _unfilter_wavefront(ftype, filt, bpp)
    return out.reshape(h, w, bpp)


def _is_png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == PNG_SIGNATURE


def _pil_image(path: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"{path}: not a PNG, and PIL, which reads other formats "
            "(JPEG), is not installed") from exc
    return Image.open(path)


def read_image(path: str) -> np.ndarray:
    """[H, W, C] uint8 pixels of an image file, C = 1, 3 or 4: PNG
    decoded here, any other format through PIL."""
    if _is_png(path):
        return decode_png(path)
    with _pil_image(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    return arr[..., None] if arr.ndim == 2 else arr


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file, from its header."""
    if _is_png(path):
        with open(path, "rb") as fh:
            head = fh.read(24)
        if len(head) < 24 or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: the first PNG chunk is not IHDR")
        return struct.unpack(">II", head[16:24])
    with _pil_image(path) as im:
        return im.size


def save_png(path: str, img_chw: np.ndarray) -> None:
    """8-bit RGB PNG of a [3,H,W] image in [0,1] (truncating quantization,
    as the JAX driver's), every row unfiltered."""
    arr = (np.clip(img_chw, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def _bicubic(x: float) -> float:
    x = abs(x)
    if x < 1.0:
        return ((_BICUBIC_A + 2.0) * x - (_BICUBIC_A + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * _BICUBIC_A
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the whole input
    span: (first input index [out], fixed-point weights [out, ksize])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(k)
        first[xx] = xmin
        weights[xx, :xmax] = [v / ww if ww != 0.0 else v for v in k]
    fixed = np.trunc(weights * (1 << _PRECISION_BITS)
                     + np.where(weights < 0, -0.5, 0.5)).astype(np.int64)
    return first, fixed


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of PIL's resampling along `axis` (0 rows, 1
    columns) of an [H, W, C] uint8 array."""
    in_size = arr.shape[axis]
    first, fixed = _coeffs(in_size, out_size)
    src = np.moveaxis(arr, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(fixed.shape[1]):
        idx = np.minimum(first + k, in_size - 1)  # weight 0 past the end
        acc += src[idx] * fixed[:, k].reshape(shape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's BICUBIC resize of an [H, W, C] uint8 array to height x width;
    the pixels unchanged where the size is the same."""
    h, w = arr.shape[:2]
    if (w, h) == (width, height):
        return arr
    if w != width:
        arr = _resample_axis(arr, width, 1)
    if h != height:
        arr = _resample_axis(arr, height, 0)
    return arr


def composite_rgba(arr: np.ndarray, white_background: bool) -> np.ndarray:
    """[H, W, 3] uint8: the image as RGBA composited over a white or black
    background, rgb * a + bg * (1 - a) in float32, truncated to 8 bits."""
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    if arr.shape[2] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=2)
    rgba = arr.astype(np.float32) / 255.0
    bg = 1.0 if white_background else 0.0
    rgb = rgba[..., :3] * rgba[..., 3:] + bg * (1 - rgba[..., 3:])
    return (rgb * 255).astype(np.uint8)


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3]: grey repeated, alpha dropped (PIL's convert("RGB"))."""
    if arr.shape[2] == 1:
        return np.repeat(arr, 3, axis=2)
    return arr[..., :3]
