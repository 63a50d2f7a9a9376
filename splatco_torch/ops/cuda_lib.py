"""Build and load the port's hand-written CUDA kernels.

Each source `splatco_torch/csrc/<name>.cu` has a plain C interface and is
compiled by `nvcc` for `sm_90a` into its own shared library, loaded with
`ctypes`.  Libraries go to `splatco_torch/_build/` (gitignored) under a
name that hashes the source, every header in `csrc/` and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.  Nothing is built at import: `build`
runs on first use, or up front (one `nvcc` per source, all started
together) when a script calls it.

`LAUNCHES` counts kernel launches by name: each wrapper adds one
(`count_launch`, under a lock, since a viewer thread launches too) where
it launches its kernel, and nowhere else.  Under a CUDA graph's capture
nothing runs: inside `captured_launches` a thread's launches are recorded
apart, and `count_replay` adds them on each replay of the graph.
`function`, `stream` and `launched` are the wrappers' shared steps: the C
entry point, the stream to launch on, and the check of a launch's CUDA
error before it counts.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# --fmad=false: no contraction of a*b+c into one rounding, so a kernel
# repeats its plain PyTorch version's float32 arithmetic op for op
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_capturing = threading.local()


def count_launch(name: str) -> None:
    recorded = getattr(_capturing, "launches", None)
    if recorded is not None:
        recorded[name] += 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def captured_launches():
    """Yields a Counter of the launches this thread makes inside the
    block, which are kept out of `LAUNCHES`."""
    _capturing.launches = collections.Counter()
    try:
        yield _capturing.launches
    finally:
        _capturing.launches = None


def count_replay(launches: collections.Counter) -> None:
    """Adds a replayed graph's recorded launches to `LAUNCHES`."""
    with _count_lock:
        LAUNCHES.update(launches)


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of the source, the
    headers it may include (every `csrc/*.cuh`) and the flags."""
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (default: all) whose library is missing,
    one `nvcc` per source, all started together.  Returns the compiler
    output of each source compiled (ptxas registers, spills, shared
    memory).  Raises if any compile fails, after every one has ended."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{logs[name]}" for name in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple, symbol: Optional[str] = None):
    """The C function `symbol` (default: `name`) of `csrc/<name>.cu`'s
    library, with its argument types set and an int result (a launch's
    CUDA error)."""
    fn = getattr(load(name), symbol or name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on `dev`."""
    return torch.cuda.current_stream(dev).cuda_stream


def launched(name: str, err: int) -> None:
    """Raises if a launch of `name` returned CUDA error `err`, else counts
    it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    count_launch(name)
