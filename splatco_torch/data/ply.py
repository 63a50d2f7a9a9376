"""Minimal PLY reader (binary little/big-endian and ascii), no third-party
deps — this package's own copy of splatco_tpu/data/ply.py's `read_ply`.
Flat float/uchar vertex properties, one 'vertex' element: the anchor PLY
schema the JAX trainer writes."""
from __future__ import annotations

import io
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
