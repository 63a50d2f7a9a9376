"""Minimal PLY I/O (binary little/big-endian and ascii), no third-party
deps — this package's own copy of splatco_tpu/data/ply.py.  Flat
float/uchar vertex properties, one 'vertex' element: the point clouds of
the scene readers and the anchor PLY schema of the checkpoints."""
from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of column arrays."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path} is not a PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    count = 0
    props: List[Tuple[str, str]] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties are not supported")
            props.append((tok[2], _PLY_TYPES[tok[1]]))

    if fmt == "ascii":
        arr = np.loadtxt(io.BytesIO(body), max_rows=count)
        arr = arr.reshape(count, len(props))
        return {name: arr[:, i].astype(dt)
                for i, (name, dt) in enumerate(props)}
    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, endian + dt) for name, dt in props])
    rec = np.frombuffer(body, dtype=dtype, count=count)
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def write_ply(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write flat named columns as a binary_little_endian 'vertex' element
    (order preserved)."""
    names = list(columns.keys())
    n = len(columns[names[0]])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    inv_types = {v: k for k, v in list(_PLY_TYPES.items())[:8]}
    dtype = np.dtype([
        (name, "<" + columns[name].dtype.str[1:]) for name in names])
    rec = np.empty(n, dtype=dtype)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name in names:
        col = np.asarray(columns[name])
        if col.ndim != 1 or len(col) != n:
            raise ValueError(f"column {name} is not [{n}]")
        rec[name] = col
        header.append(f"property {inv_types[col.dtype.str[1:]]} {name}")
    header.append("end_header")
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(rec.tobytes())


def fetch_point_cloud(path: str):
    """(points [N,3], colors [N,3] in [0,1], normals [N,3]) float32 of a
    point-cloud PLY; colors and normals are zeros where it has none."""
    v = read_ply(path)
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]],
                          axis=1).astype(np.float32) / 255.0
    else:
        colors = np.zeros_like(points)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1
                           ).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """A point cloud as PLY: xyz float32, zero normals, rgb uint8."""
    xyz = np.asarray(xyz, np.float32)
    cols = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": np.asarray(rgb[:, 0], np.uint8),
        "green": np.asarray(rgb[:, 1], np.uint8),
        "blue": np.asarray(rgb[:, 2], np.uint8),
    }
    write_ply(path, cols)
