"""The tri-plane sampler: bilinear samples of a plane [R, H, W] at
normalized coordinates (u on the H axis, v on the W axis, both in
[-1, 1], align_corners, zeros outside), with a hand-written gradient.
Counterpart of `_sample_plane` in splatco_tpu/models/triplane.py, an XLA
gather there (and its `jax.grad` an XLA scatter-add), here a pair of CUDA
kernels: `csrc/plane_sample_fwd.cu` and `csrc/plane_sample_bwd.cu`.

`sample_plane(plane, u, v)` is the autograd entry point, [N] -> [N, R].
Its forward gathers the four corners of each row and, when the plane
needs a gradient, writes each (row, corner)'s cell, the key table's keys
(a corner off the plane gets the key H * W, which sorts after every cell
and is never summed); `key_table` sorts them stably, so each cell's
entries stay in row order.  The backward sums each cell's entries in an
order fixed by the table alone (a segmented scan within chunks of
`CHUNK` entries, then the parts of a run that crosses chunks, `GROUP` at
a time by an xor butterfly, in chunk order), with no float atomics, so a
step repeats bit for bit; the coordinates' gradients are per row.

For CUDA tensors `plane_sample_fwd` and `plane_sample_bwd` launch their
kernels (each call adds one to `cuda_lib.LAUNCHES`); for CPU tensors they
run the plain versions beside them; any other device raises.  There is no
fallback from one to the other.  The plain versions repeat the kernels'
float32 operations in the kernels' order (the kernels are built with
--fmad=false), so on the same inputs the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from splatco_torch.ops import cuda_lib

FWD_KERNEL = "plane_sample_fwd"
BWD_KERNEL = "plane_sample_bwd"
CHUNK = 256  # key-table entries a block of the backward (kChunk)
GROUP = 32   # a run's chunk parts added per butterfly round (a warp)

Table = Tuple[torch.Tensor, torch.Tensor]  # sorted keys int32, order int64


def _cell(u: torch.Tensor, v: torch.Tensor, h: int, w: int):
    """(x0, y0, tx, ty) of rows (u, v): the texel lattice coordinates'
    floors and fractions (`cell_of` in csrc/plane_sample.cuh)."""
    x = (u + 1.0) * 0.5 * (h - 1)
    y = (v + 1.0) * 0.5 * (w - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0, y0, x - x0, y - y0


def _corner(cell, k, h: int, w: int):
    """Corner k of `cell` (bit 0 steps x, bit 1 steps y; an int or a
    tensor of them): (weight, in-bounds, flat index clamped onto the
    plane) (`corner` in csrc/plane_sample.cuh)."""
    x0, y0, tx, ty = cell
    k = torch.as_tensor(k, device=x0.device)
    sx, sy = (k & 1) == 1, (k & 2) == 2
    cx = torch.where(sx, x0 + 1, x0)
    cy = torch.where(sy, y0 + 1, y0)
    wgt = torch.where(sx, tx, 1 - tx) * torch.where(sy, ty, 1 - ty)
    inb = (cx >= 0) & (cx <= h - 1) & (cy >= 0) & (cy <= w - 1)
    idx = (torch.clamp(cx, 0, h - 1).to(torch.int64) * w
           + torch.clamp(cy, 0, w - 1).to(torch.int64))
    return wgt, inb, idx


def plane_sample_fwd_plain(plane: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample plane [R, H, W] at normalized coords u (H axis),
    v (W axis) in [-1, 1]; align_corners=True, zeros outside.  [N] -> [N,R].
    The four corners are gathered and weighted explicitly, each texel
    times (weight times its in-bounds flag), summed in corner order."""
    r, h, w = plane.shape
    flat = plane.reshape(r, h * w)
    cell = _cell(u, v, h, w)
    out = None
    for k in range(4):
        wgt, inb, idx = _corner(cell, k, h, w)
        term = flat[:, idx] * (wgt * inb.to(plane.dtype))[None, :]
        out = term if out is None else out + term
    return out.T


def corner_keys_plain(u: torch.Tensor, v: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
    """keys [4 N] int32: entry 4 n + k is corner k's cell of row n, or
    h * w where the corner lies off the plane (the forward kernel's
    keys)."""
    cell = _cell(u, v, h, w)
    keys = []
    for k in range(4):
        _, inb, idx = _corner(cell, k, h, w)
        keys.append(torch.where(inb, idx, h * w))
    return torch.stack(keys, dim=1).reshape(-1).to(torch.int32)


def key_table(keys: torch.Tensor) -> Table:
    """The key table: the keys sorted stably (equal cells keep row order,
    the off-plane corners last) and each sorted entry's index 4 n + k."""
    return torch.sort(keys, stable=True)


def _scan_chunks(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The backward kernel's segmented Hillis-Steele scan: key [C, CHUNK],
    val [C, CHUNK, R] -> each entry's sum of its run from the chunk's
    start (or the run's) up to itself, in the kernel's order."""
    d = 1
    while d < CHUNK:
        prev_key = torch.nn.functional.pad(key, (d, 0), value=-1)[:, :-d]
        prev_val = torch.nn.functional.pad(val, (0, 0, d, 0))[:, :-d]
        val = torch.where((prev_key == key)[..., None], prev_val + val, val)
        d *= 2
    return val


def _plane_grad_plain(g, u, v, plane, table: Table) -> torch.Tensor:
    """d_plane [R, H, W] in the backward kernel's order of sums."""
    r, h, w = plane.shape
    cells, dev = h * w, plane.device
    keys, order = table
    total = keys.numel()
    chunks = -(-total // CHUNK)
    pad = chunks * CHUNK - total
    key = torch.nn.functional.pad(keys.to(torch.int64), (0, pad),
                                  value=cells)
    valid = key < cells
    e = torch.where(valid, torch.nn.functional.pad(order, (0, pad)), 0)
    row = e // 4
    wgt, _, _ = _corner(_cell(u[row], v[row], h, w), e % 4, h, w)
    val = torch.where(valid[:, None], g[row] * wgt[:, None], 0.0)
    key = key.view(chunks, CHUNK)
    val = _scan_chunks(key, val.view(chunks, CHUNK, r))
    valid = valid.view(chunks, CHUNK)

    ends = torch.ones_like(key, dtype=torch.bool)
    ends[:, :-1] = key[:, 1:] != key[:, :-1]
    before = torch.cat([key.new_full((1,), -1), key[:-1, -1]])
    started = (key == key[:, :1]) & (before[:, None] == key)
    after = torch.cat([key[1:, 0], key.new_full((1,), -1)])
    crosses = torch.zeros_like(ends)
    crosses[:, -1] = after == key[:, -1]
    out = torch.zeros((r, cells), dtype=plane.dtype, device=dev)
    whole = ends & valid & ~started & ~crosses
    out[:, key[whole]] = val[whole].T
    head = torch.zeros((chunks, r), dtype=plane.dtype, device=dev)
    part = ends & valid & started
    head[part.nonzero()[:, 0]] = val[part]
    owner = (crosses[:, -1] & valid[:, -1] & ~started[:, -1]).nonzero()[:, 0]
    if owner.numel():
        run_key = key[owner, -1]
        idx = torch.arange(chunks, device=dev)
        length = ((key[None, :, 0] == run_key[:, None])
                  & (idx[None, :] > owner[:, None])).sum(1)
        rounds = -(-length // GROUP)
        span = int(rounds.max()) * GROUP
        j = owner[:, None] + 1 + torch.arange(span, device=dev)[None, :]
        part = torch.where(
            (j - owner[:, None] - 1 < length[:, None])[..., None],
            head[j.clamp(max=chunks - 1)], 0.0)
        part = part.view(owner.numel(), -1, GROUP, r)
        while part.shape[2] > 1:
            half = part.shape[2] // 2
            part = part[:, :, :half] + part[:, :, half:]
        acc = val[owner, -1]
        for i in range(part.shape[1]):
            acc = torch.where((i < rounds)[:, None], acc + part[:, i, 0], acc)
        out[:, run_key] = acc.T
    return out.view(r, h, w)


def _coord_grads_plain(g, u, v, plane):
    """(d_u, d_v) [N] in the backward kernel's order: the channels summed
    one after another."""
    r, h, w = plane.shape
    flat = plane.reshape(r, h * w)
    cell = _cell(u, v, h, w)
    corners = [_corner(cell, k, h, w)[1:] for k in range(4)]
    _, _, tx, ty = cell
    dtx = torch.zeros_like(u)
    dty = torch.zeros_like(u)
    for ch in range(r):
        c00, c10, c01, c11 = (flat[ch, idx] * inb.to(plane.dtype)
                              for inb, idx in corners)
        gr = g[:, ch]
        dtx = dtx + gr * ((1 - ty) * (c10 - c00) + ty * (c11 - c01))
        dty = dty + gr * ((1 - tx) * (c01 - c00) + tx * (c11 - c10))
    return dtx * (h - 1) * 0.5, dty * (w - 1) * 0.5


def plane_sample_bwd_plain(g: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, plane: torch.Tensor,
                           table: Optional[Table], coords: bool = True):
    """The sampler's gradients for the output cotangent g [N, R]:
    (d_plane [R, H, W] or None without a table, d_u, d_v [N] or None
    without `coords`), each sum in the backward kernel's order."""
    d_plane = (None if table is None
               else _plane_grad_plain(g, u, v, plane, table))
    d_u, d_v = (_coord_grads_plain(g, u, v, plane) if coords
                else (None, None))
    return d_plane, d_u, d_v


def _check(plane, u, v):
    if plane.dim() != 3 or not plane.is_contiguous():
        raise ValueError(f"plane must be a contiguous [R, H, W], got "
                         f"{tuple(plane.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.dim() != 1 or t.shape != u.shape or t.device != plane.device \
                or t.dtype != plane.dtype:
            raise ValueError(f"{name} must be [N] {plane.dtype} on "
                             f"{plane.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if plane.device.type == "cuda" and plane.dtype != torch.float32:
        raise ValueError(f"{FWD_KERNEL} takes float32, got {plane.dtype}")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{FWD_KERNEL}: unsupported device {plane.device}")
    r, h, w = plane.shape
    if 4 * u.shape[0] >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError("the key table's int32 entries cannot hold "
                         f"{u.shape[0]} rows of a {h}x{w} plane")


@functools.lru_cache(maxsize=None)
def _kernel(name: str, argtypes: tuple):
    fn = getattr(cuda_lib.load(name), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def plane_sample_fwd(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     keys: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(samples [N, R], the key table's keys [4 N] int32 with `keys`, else
    None)."""
    _check(plane, u, v)
    r, h, w = plane.shape
    if plane.device.type == "cpu":
        return (plane_sample_fwd_plain(plane, u, v),
                corner_keys_plain(u, v, h, w) if keys else None)
    n = u.shape[0]
    out = torch.empty((n, r), dtype=torch.float32, device=plane.device)
    key_out = (torch.empty(4 * n, dtype=torch.int32, device=plane.device)
               if keys else None)
    fn = _kernel(FWD_KERNEL, (_P, _P, _L, _P, _L, _L, _I, _I, _I, _P, _P,
                              _P))
    with torch.cuda.device(plane.device):
        err = fn(plane.data_ptr(), u.data_ptr(), u.stride(0), v.data_ptr(),
                 v.stride(0), n, r, h, w, out.data_ptr(), _ptr(key_out),
                 _stream(plane.device))
    if err != 0:
        raise RuntimeError(f"{FWD_KERNEL} launch failed: CUDA error {err}")
    cuda_lib.count_launch(FWD_KERNEL)
    return out, key_out


def plane_sample_bwd(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     plane: torch.Tensor, table: Optional[Table],
                     coords: bool = True):
    """(d_plane [R, H, W] or None without a table, d_u, d_v [N] or None
    without `coords`) for the output cotangent g [N, R]."""
    _check(plane, u, v)
    r, h, w = plane.shape
    n = u.shape[0]
    if g.shape != (n, r) or g.dtype != plane.dtype \
            or g.device != plane.device:
        raise ValueError(f"g must be [{n}, {r}] {plane.dtype} on "
                         f"{plane.device}, got {g.dtype} {tuple(g.shape)}")
    if plane.device.type == "cpu":
        return plane_sample_bwd_plain(g, u, v, plane, table, coords)
    if g.stride(1) != 1:
        g = g.contiguous()
    dev = plane.device
    d_plane = keys = order = head = tail = None
    total = 0
    if table is not None:
        keys, order = table
        total = keys.numel()
        if keys.dtype != torch.int32 or order.dtype != torch.int64 \
                or order.shape != keys.shape or total != 4 * n:
            raise ValueError("the key table must be int32 keys and int64 "
                             f"order, [{4 * n}] each")
        chunks = -(-total // CHUNK)
        d_plane = torch.empty_like(plane)
        head = torch.empty((chunks, r), dtype=torch.float32, device=dev)
        tail = torch.empty((chunks, r), dtype=torch.float32, device=dev)
    d_u = torch.empty(n, dtype=torch.float32, device=dev) if coords else None
    d_v = torch.empty(n, dtype=torch.float32, device=dev) if coords else None
    fn = _kernel(BWD_KERNEL, (_P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _I, _P,
                              _P, _L, _P, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), g.stride(0), u.data_ptr(), u.stride(0),
                 v.data_ptr(), v.stride(0), plane.data_ptr(), n, r, h, w,
                 _ptr(keys), _ptr(order), total, _ptr(head), _ptr(tail),
                 _ptr(d_plane), _ptr(d_u), _ptr(d_v), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: CUDA error {err}")
    cuda_lib.count_launch(BWD_KERNEL)
    return d_plane, d_u, d_v


class _PlaneSample(torch.autograd.Function):
    """The sampler with its hand-written gradient.  The key table is
    built only when the plane needs a gradient."""

    @staticmethod
    def forward(ctx, plane, u, v):
        need_plane = ctx.needs_input_grad[0]
        with torch.profiler.record_function("plane_sample"):
            out, keys = plane_sample_fwd(plane, u, v, keys=need_plane)
            table = key_table(keys) if need_plane else (None, None)
        ctx.save_for_backward(plane, u, v, *table)
        return out

    @staticmethod
    def backward(ctx, g):
        plane, u, v, keys, order = ctx.saved_tensors
        need_plane, need_u, need_v = ctx.needs_input_grad
        with torch.profiler.record_function("plane_sample"):
            d_plane, d_u, d_v = plane_sample_bwd(
                g, u, v, plane, (keys, order) if need_plane else None,
                coords=need_u or need_v)
        return (d_plane, d_u if need_u else None, d_v if need_v else None)


def sample_plane(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample plane [R, H, W] at normalized coords u (H axis), v
    (W axis) in [-1, 1]; align_corners=True, zeros outside.  [N] -> [N, R],
    differentiable in all three."""
    if torch.is_grad_enabled() and (plane.requires_grad or u.requires_grad
                                    or v.requires_grad):
        return _PlaneSample.apply(plane, u, v)
    with torch.profiler.record_function("plane_sample"):
        return plane_sample_fwd(plane, u, v)[0]
