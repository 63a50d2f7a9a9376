"""Probes of the mechanics a tile-blend kernel rests on: the CUDA kernels'
wrappers and their plain PyTorch versions (counterparts of the Pallas
probes of tools/micro_mosaic.py; the port's tool is
tools/micro_mosaic_torch.py).

  extract_rows   window row sums at an arbitrary element offset
                 (`kernel`, micro_mosaic.py:64): `csrc/probe_extract.cu`,
                 modes direct / smem / shfl;
  cumsum_rows    inclusive cumsum over rows as the product L x
                 (`cs_kernel`, :88): `csrc/probe_cumsum.cu`, modes tf32 /
                 fp32; NaN above a non-finite value, as L's zeros give;
  accumulate_    in-place accumulation over sequential steps (`acc_kernel`,
                 :140): `csrc/probe_accum.cu`;
  alpha_sums     the 1-D alpha evaluation summed over a chunk's records
                 (`blend_kernel`, :171): `csrc/probe_blend.cu`, extract
                 off / on.

For CUDA tensors each wrapper launches its kernel and adds one to
`cuda_lib.LAUNCHES["<kernel>[<mode>]"]`; for CPU tensors it runs the plain
version; any other device raises.  There is no fallback from one to the
other.  The plain versions add in the kernels' order, so on the same
inputs they agree bit for bit (`alpha_sums` with NaN where the plain
version is NaN: the kernel's expf and torch's CUDA exp are both
libdevice's), except `cumsum_rows` in tf32 mode, whose tensor-core sums
are held to a tolerance (NaN and inf at the plain version's positions).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from splatco_torch.ops import cuda_lib

REC = 16      # record rows of a window
WIN = 128     # records (columns) of a window
OUT_ROWS = 8  # rows of extract_rows' output per chunk; row 0 holds sums
PIX = 256     # pixels of alpha_sums per chunk
CUMSUM_MAX_ROWS = 1024  # rows of cumsum_rows: the kernel stages them all
ACC_STEPS = 4  # the sequential steps of accumulate_
ACCUM_THREADS = 256  # threads a block of csrc/probe_accum.cu

EXTRACT = "probe_extract"
CUMSUM = "probe_cumsum"
ACCUM = "probe_accum"
BLEND = "probe_blend"
EXTRACT_MODES = ("direct", "smem", "shfl")
CUMSUM_MODES = ("tf32", "fp32")
BLEND_MODES = (False, True)  # extract off / on


def _check(t: torch.Tensor, name: str, dtype, dim: int):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_windows(data: torch.Tensor, starts: torch.Tensor):
    _check(data, "data", torch.float32, 2)
    _check(starts, "starts", torch.int32, 1)
    if data.shape[0] != REC or starts.device != data.device:
        raise ValueError(f"data must be [{REC}, width] and starts on its "
                         f"device, got {tuple(data.shape)}, {starts.device}")


def _device(t: torch.Tensor, name: str) -> str:
    """'cpu' (take the plain version) or 'cuda' (launch); raises
    otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


@functools.lru_cache(maxsize=None)
def _kernel(name: str, *argtypes):
    fn = getattr(cuda_lib.load(name), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, key: str, t: torch.Tensor, fn, *args):
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_lib.count_launch(key)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _windows(data: torch.Tensor, col0: torch.Tensor) -> torch.Tensor:
    """[rows, n, WIN]: columns col0 .. col0 + WIN - 1 of each row of
    `data`, 0 outside [0, width)."""
    width = data.shape[1]
    cols = col0.to(torch.int64)[:, None] + torch.arange(WIN,
                                                        device=data.device)
    inside = (cols >= 0) & (cols < width)
    return torch.where(inside, data[:, cols.clamp(0, width - 1)], 0.0)


def extract_rows_plain(data: torch.Tensor,
                       starts: torch.Tensor) -> torch.Tensor:
    """out [n, 8, 16]: out[c, 0, r] = sum of data[r, p : p + 128] for p =
    starts[c] (columns outside the array read 0), rows 1-7 zero.  Added
    as the kernel adds: lane l sums columns l + 32 j in order, then an
    xor butterfly over the 32 lanes."""
    win = _windows(data, starts).reshape(REC, -1, 4, 32)
    s = win[:, :, 0] + win[:, :, 1]
    s = s + win[:, :, 2]
    s = s + win[:, :, 3]
    lanes = torch.arange(32, device=data.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, :, lanes ^ off]
    out = torch.zeros((starts.shape[0], OUT_ROWS, REC), device=data.device)
    out[:, 0] = s[:, :, 0].T
    return out


def extract_rows(data: torch.Tensor, starts: torch.Tensor,
                 mode: str = "direct") -> torch.Tensor:
    """Window row sums [n, 8, 16] of data [16, width] at the int32 starts
    [n], by the kernel's `mode` (direct, smem or shfl: one function)."""
    _check_windows(data, starts)
    mode_id = EXTRACT_MODES.index(mode)
    if _device(data, EXTRACT) == "cpu":
        return extract_rows_plain(data, starts)
    out = torch.empty((starts.shape[0], OUT_ROWS, REC), device=data.device)
    fn = _kernel(EXTRACT, _I, _P, _LL, _P, _I, _P, _P)
    _launch(EXTRACT, f"{EXTRACT}[{mode}]", data, fn, mode_id,
            data.data_ptr(), data.shape[1], starts.data_ptr(),
            starts.shape[0], out.data_ptr())
    return out


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """L x with L [K, K] lower-triangular ones, as the reference's float32
    product gives it: out[i] the running sum x[0] + ... + x[i] from +0.0,
    added row by row (the fp32 kernel's order), and NaN in row i of every
    column with an inf or NaN in a later row (L's zero times it).  For
    finite x L's zeros add +-0.0 to a sum that never becomes -0.0, so the
    bits are the running sum's."""
    out = torch.empty_like(x)
    s = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        s = s + x[i]
        out[i] = s
    bad = (~torch.isfinite(x)).to(torch.int32)
    later = torch.zeros_like(bad, dtype=torch.bool)
    later[:-1] = bad.flip(0).cumsum(0).flip(0)[1:] > 0
    return out.masked_fill_(later, float("nan"))


def cumsum_rows(x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """Inclusive cumsum over dim 0 of x [K, N] (K, N multiples of 16) as
    the product L x with L lower-triangular ones (`cumsum_rows_plain`'s
    meaning): on the tensor cores in TF32 (mode tf32) or as the fp32
    running sum (mode fp32).  K at most CUMSUM_MAX_ROWS."""
    _check(x, "x", torch.float32, 2)
    if x.shape[0] % 16 or x.shape[1] % 16 or x.shape[0] > CUMSUM_MAX_ROWS:
        raise ValueError(f"x must be [16 a, 16 b] with at most "
                         f"{CUMSUM_MAX_ROWS} rows, got {tuple(x.shape)}")
    mode_id = CUMSUM_MODES.index(mode)
    if _device(x, CUMSUM) == "cpu":
        return cumsum_rows_plain(x)
    out = torch.empty_like(x)
    fn = _kernel(CUMSUM, _I, _P, _I, _I, _P, _P)
    _launch(CUMSUM, f"{CUMSUM}[{mode}]", x, fn, mode_id, x.data_ptr(),
            x.shape[0], x.shape[1], out.data_ptr())
    return out


def accumulate_plain_(out: torch.Tensor, inp: torch.Tensor,
                      steps: int = ACC_STEPS) -> torch.Tensor:
    """`out += inp` on the even ones of `steps` sequential steps, in
    place."""
    for step in range(steps):
        if step % 2 == 0:
            out.add_(inp)
    return out


def accum_plan(in_addr: int, out_addr: int, n: int):
    """(head, nvec, blocks): how `probe_accum` splits n elements at these
    addresses.  Where in and out sit at one offset modulo 16 B, elements
    head .. head + 4 nvec - 1 go as nvec 16 B vectors, the head (up to 3
    elements before out's first 16 B boundary) and the tail (up to 3
    after the last vector) one element a thread; otherwise every element
    goes alone (nvec 0).  The grid holds a thread a vector and a thread
    an element left over."""
    head = nvec = 0
    if in_addr % 16 == out_addr % 16:
        head = min(n, -out_addr % 16 // 4)
        nvec = (n - head) // 4
    units = nvec + n - 4 * nvec
    return head, nvec, -(-units // ACCUM_THREADS)


def accumulate_(out: torch.Tensor, inp: torch.Tensor,
                steps: int = ACC_STEPS) -> torch.Tensor:
    """Add `inp` into `out` on the even ones of `steps` sequential steps.
    `out` is the caller's pre-zeroed buffer and is updated in place (the
    PyTorch counterpart of the TPU kernel's output aliasing a zeros
    input); for out = 0 and inp = 1 every element ends at 2.0.  Any
    alignment: `accum_plan` picks 16 B vectors where out and inp allow
    them.  `inp` must not overlap `out` (the kernel reads it once, the
    plain version after each add).  Returns `out`."""
    for name, t in (("out", out), ("inp", inp)):
        _check(t, name, torch.float32, out.dim())
    if inp.shape != out.shape or inp.device != out.device:
        raise ValueError("out and inp must have one shape and device")
    dev = _device(out, ACCUM)
    size = 4 * out.numel()
    if size and (inp.data_ptr() < out.data_ptr() + size
                 and out.data_ptr() < inp.data_ptr() + size):
        raise ValueError("out and inp overlap")
    if dev == "cpu":
        return accumulate_plain_(out, inp, steps)
    n = out.numel()
    head, nvec, blocks = accum_plan(inp.data_ptr(), out.data_ptr(), n)
    fn = _kernel(ACCUM, _P, _P, _LL, _I, _LL, _LL, _LL, _P)
    _launch(ACCUM, ACCUM, out, fn, inp.data_ptr(), out.data_ptr(), n,
            steps, head, nvec, blocks)
    return out


def alpha_sums_plain(data: torch.Tensor, starts: torch.Tensor,
                     extract: bool) -> torch.Tensor:
    """out [n, 2, 128]: for chunk c, with the records at columns col0 +
    k, k < 128 (col0 = starts[c] if `extract`, else the aligned block
    128 (starts[c] // 128)) and m, q, o their rows 0, 2, 5:
    out[c].flat[px] = sum over k of o exp((-0.5 q) (m - px) (m - px)),
    px = 0 .. 255, added in k order."""
    col0 = starts.to(torch.int64)
    if not extract:
        col0 = col0 & ~(WIN - 1)
    m, q, o = _windows(data[[0, 2, 5]], col0)
    px = torch.arange(PIX, dtype=torch.float32, device=data.device)
    s = torch.zeros((starts.shape[0], PIX), device=data.device)
    for k in range(WIN):
        dx = m[:, k, None] - px
        t = -0.5 * q[:, k, None]
        t = t * dx
        t = t * dx
        s = s + o[:, k, None] * torch.exp(t)
    return s.reshape(-1, 2, PIX // 2)


def alpha_sums(data: torch.Tensor, starts: torch.Tensor,
               extract: bool) -> torch.Tensor:
    """The alpha-sum probe [n, 2, 128] of data [16, width] at the int32
    starts [n], records from the window at each start (`extract`) or from
    its aligned 128-column block."""
    _check_windows(data, starts)
    if _device(data, BLEND) == "cpu":
        return alpha_sums_plain(data, starts, extract)
    out = torch.empty((starts.shape[0], 2, PIX // 2), device=data.device)
    fn = _kernel(BLEND, _I, _P, _LL, _P, _I, _P, _P)
    _launch(BLEND, f"{BLEND}[extract={extract}]", data, fn, int(extract),
            data.data_ptr(), data.shape[1], starts.data_ptr(),
            starts.shape[0], out.data_ptr())
    return out
