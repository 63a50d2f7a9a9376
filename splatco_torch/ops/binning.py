"""Tile binning (counterpart of splatco_tpu/ops/binning.py) on the 32 px
grid of the v2 configuration, or at any power-of-two tile size:
ops/raster_v3.py bins the v3 configuration's 16 px grid with the same
kernels, its slots ranked in parent-major tile order.

  1. per-gaussian tile rects, clipped to `kmax` tiles around the centre
     (`_rects`, identical to the JAX package's, with the `num_clipped`
     count),
  2. the [kmax, N] j-major slot grid with the exact ellipse-reach test
     (`_slot_grid`, identical to the JAX package's): a dropped slot has
     max alpha < 1/255 over its tile, which the blend skips anyway,
  3. only the valid (tile, gaussian) pairs are emitted — a dynamic count,
     no static slot budget — in depth order within each tile; among pairs
     of one tile at equal depth, the lower slot rank, then the lower
     gaussian index, comes first (the order of the JAX package's stable
     sort over its j-major slot array),
  4. the 9 record columns are gathered into SoA [9, P] float32, with the
     per-tile [start, end) ranges,
  5. the slot mask `slot_mask` [ceil(kmax / 32), N] int32 has bit j % 32
     of word j // 32 of gaussian n set where slot rank j of n holds a
     record, and the slot map `slot_pos` [N, kmax] (gaussian-major) gives
     that record's position; outside the mask the map is undefined (the
     card never fills it; the plain version writes -1 there).  The
     backward gathers the per-record gradients through the set slots and
     sums over j in order (`reduce_slots` of ops/rasterize.py): a
     deterministic per-gaussian reduce with no scatter-add.

Three CUDA kernels run steps 1-5 on the card (csrc/binning.cuh holds
the per-gaussian arithmetic and the warp-wide slot enumeration of the
first two):

  bin_count       (csrc/bin_count.cu)  the pairs per tile, their offsets
                  tile_start / tile_end, and the counters num_clipped,
                  max_slots, the pair count P and the longest segment,
  bin_place       (csrc/bin_place.cu)  each pair's key
                  float_bits(depth) << 32 | (j * N + n) in its tile's
                  segment, in an order the atomics choose,
  bin_sort_tiles  (csrc/bin_sort_tiles.cu)  each segment's keys sorted
                  (unique keys: the order bin_place left does not
                  matter), then records, gauss_id, slot_pos and
                  slot_mask.

In bin_count and bin_place a warp takes 32 rows and its lanes share
those rows' slots, 32 a round.  bin_count runs persistent blocks (two an
SM) that count into a histogram of every tile in shared memory up to
SHARED_TILES tiles (one flush a block; the last block scans); bin_place
visits each gaussian once, the lanes of a round that hit one tile
reserving their run of its cursor with one atomic.

The low word of a key is j * N + n, the pair's flat index in a j-major
[kmax, N] grid, so kmax * N must stay below 2^31: the wrappers raise
above that (and the positions in the slot map fit its int32).  No
tensor of kmax * N elements is filled or read: the map is allocated
unfilled, and only the mask (4 B a gaussian a word) is zeroed.  P and the
longest segment are read back once a call, after bin_count (the
binning's one host sync).  For CUDA tensors each wrapper launches its
kernel (adding one to `cuda_lib.LAUNCHES`) or raises; for CPU tensors it
runs the plain version beside it, the torch code of the same function.
The plain versions composed (`bin_gaussians_plain`, any device) give the same BinnedGaussians as the kernels, bit for bit.

The JAX package's static budgets (`kmax_pack`, `class_spec`, chunk maps)
exist only to give XLA static shapes; they have no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from splatco_torch.ops import cuda_lib
from splatco_torch.ops.projection import ProjectedCols, rect_bounds

TILE = 32
# record rows
C_MX, C_MY, C_CA, C_CB, C_CC, C_OP, C_R, C_G, C_B = range(9)
NUM_REC = 9

COUNT_KERNEL, PLACE_KERNEL, SORT_KERNEL = ("bin_count", "bin_place",
                                           "bin_sort_tiles")
KERNELS = (COUNT_KERNEL, PLACE_KERNEL, SORT_KERNEL)
# a key's low word, the pair's flat slot-map index j * N + n, is int32
MAX_SLOTS = 2 ** 31
# the most tiles bin_count counts per block in shared memory (224 KiB of
# int32, csrc/binning.cuh's kSharedTiles; v3 at 3840x2160 has 32,640); on
# a larger grid (v3 at 7680x4320: 129,600) it counts with global atomics.
# bin_place reserves from the global cursors on every grid
SHARED_TILES = 57344
# slot ranks a word of the slot mask holds
MASK_BITS = 32
# flips a key's sign bit: int64 order of the flipped keys is their uint64
# order
_SIGN = -2 ** 63


class BinnedGaussians(NamedTuple):
    records: torch.Tensor     # [9, P] f32, tile segments front to back
    gauss_id: torch.Tensor    # [P] i64: the gaussian of each record
    tile_start: torch.Tensor  # [num_tiles] i32 segment starts
    tile_end: torch.Tensor    # [num_tiles] i32 segment ends
    num_clipped: torch.Tensor  # [] i64: gaussians whose rect was clipped
    max_slots: torch.Tensor    # [] i64: most reach-valid tiles of one
                               #   gaussian
    slot_pos: torch.Tensor     # [N, kmax] i32: record position of each
                               #   (gaussian, slot rank) under the mask
    slot_mask: torch.Tensor    # [ceil(kmax / 32), N] i32: bit j % 32 of
                               #   word j // 32 set where rank j holds one


class SortedTiles(NamedTuple):
    records: torch.Tensor     # [9, P] f32
    gauss_id: torch.Tensor    # [P] i64
    slot_pos: torch.Tensor    # [N, kmax] i32, defined under the mask
    slot_mask: torch.Tensor   # [ceil(kmax / 32), N] i32


class TileCounts(NamedTuple):
    tile_start: torch.Tensor  # [num_tiles] i32
    tile_end: torch.Tensor    # [num_tiles] i32
    stats: torch.Tensor       # [4] i64: num_clipped, max_slots, pairs,
                              #   longest segment


def _rects(mx, my, rad, tile_size: int, tiles_x: int, tiles_y: int,
           kmax: int):
    """Per-gaussian clipped tile rects: (x0, y0, sx_c, counts, clipped)."""
    i32 = torch.int32
    x0, y0, x1, y1 = rect_bounds(mx, my, rad, tile_size, tiles_x, tiles_y)
    sx = torch.clamp_min(x1 - x0, 0)
    sy = torch.clamp_min(y1 - y0, 0)
    clipped = (sx * sy > kmax) & (rad > 0)
    # saturate before the cast, as XLA's float->int conversion does
    lim = float(2 ** 30)
    cx = torch.clamp(torch.clamp(mx / tile_size, -lim, lim).to(i32),
                     0, tiles_x - 1)
    cy = torch.clamp(torch.clamp(my / tile_size, -lim, lim).to(i32),
                     0, tiles_y - 1)
    sx_c = torch.clamp_max(sx, kmax)
    sy_c = torch.minimum(sy, torch.clamp_min(kmax // torch.clamp_min(sx_c, 1),
                                             1))
    sx_c = torch.minimum(sx_c,
                         torch.clamp_min(kmax // torch.clamp_min(sy_c, 1), 1))
    sx_c = torch.where(clipped, sx_c, sx)
    sy_c = torch.where(clipped, sy_c, sy)
    x0 = torch.where(clipped,
                     torch.clamp(cx - sx_c // 2, x0,
                                 torch.maximum(x1 - sx_c, x0)), x0)
    y0 = torch.where(clipped,
                     torch.clamp(cy - sy_c // 2, y0,
                                 torch.maximum(y1 - sy_c, y0)), y0)
    counts = torch.where(rad > 0, sx_c * sy_c, 0)
    return x0, y0, sx_c, counts, clipped


def _slot_grid(mx, my, ca, cb, cc, op, x0, y0, sx_c, counts,
               tile_size: int, tiles_x: int, kmax: int, num_tiles: int):
    """[kmax, N] tile-of-slot grid (j-major enumeration of the clipped
    rect) with the exact ellipse-reach test; invalid slots get
    `num_tiles`."""
    j = torch.arange(kmax, dtype=torch.int32, device=mx.device)[:, None]
    w = torch.clamp_min(sx_c, 1)[None, :]
    ly = j // w
    lx = j % w
    txs = x0[None, :] + lx
    tys = y0[None, :] + ly

    u0 = (txs * tile_size).to(torch.float32) - mx[None, :]
    u1 = u0 + (tile_size - 1)
    v0 = (tys * tile_size).to(torch.float32) - my[None, :]
    v1 = v0 + (tile_size - 1)
    cae, cbe, cce = ca[None, :], cb[None, :], cc[None, :]
    r_vc = (-cb / torch.where(cc != 0.0, cc, 1.0))[None, :]
    r_uc = (-cb / torch.where(ca != 0.0, ca, 1.0))[None, :]

    def _edge_u(u):
        vs = torch.clamp(r_vc * u, v0, v1)
        return cae * u * u + 2.0 * cbe * u * vs + cce * vs * vs

    def _edge_v(v):
        us = torch.clamp(r_uc * v, u0, u1)
        return cae * us * us + 2.0 * cbe * us * v + cce * v * v

    inside = (u0 <= 0) & (0 <= u1) & (v0 <= 0) & (0 <= v1)
    qmin = torch.minimum(torch.minimum(_edge_u(u0), _edge_u(u1)),
                         torch.minimum(_edge_v(v0), _edge_v(v1)))
    qmin = torch.where(inside, 0.0, qmin)
    reach = (qmin * (1.0 - 1e-3)
             <= 2.0 * torch.log(255.0 * torch.clamp_min(op, 1e-12))[None, :])
    slot_valid = (j < counts[None, :]) & reach
    return torch.where(slot_valid, tys * tiles_x + txs,
                       num_tiles).to(torch.int32)


def slot_tiles(proj: ProjectedCols, opacities: torch.Tensor,
               tile_size: int, tiles_x: int, tiles_y: int, kmax: int,
               parent_major: bool = False):
    """(tile_of_slot [kmax, N] int32 with `num_tiles` for an invalid slot,
    clipped [N] bool): steps 1-2 above, each gaussian's slots in rank
    order (with `parent_major`, v3's parent-major tile order, invalid
    slots last)."""
    x0, y0, sx_c, counts, clipped = _rects(
        proj.mx, proj.my, proj.radius.to(torch.float32), tile_size,
        tiles_x, tiles_y, kmax)
    num_tiles = tiles_x * tiles_y
    tile_of_slot = _slot_grid(proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                              opacities.to(torch.float32), x0, y0, sx_c,
                              counts, tile_size, tiles_x, kmax, num_tiles)
    if parent_major:
        from splatco_torch.ops.raster_v3 import parent_major_slots
        tile_of_slot = parent_major_slots(tile_of_slot, tiles_x, num_tiles)
    return tile_of_slot, clipped


# ---------------------------------------------------------------------
# plain versions of the kernels


def bin_count_plain(proj: ProjectedCols, opacities: torch.Tensor,
                    tile_size: int, tiles_x: int, tiles_y: int, kmax: int,
                    parent_major: bool = False) -> TileCounts:
    """What `bin_count` computes: the pairs per tile as segment offsets,
    and the counters (no count depends on `parent_major`)."""
    num_tiles = tiles_x * tiles_y
    tile_of_slot, clipped = slot_tiles(proj, opacities, tile_size, tiles_x,
                                       tiles_y, kmax)
    valid = tile_of_slot < num_tiles
    per_tile = torch.bincount(tile_of_slot[valid].to(torch.int64),
                              minlength=num_tiles)
    tile_end = torch.cumsum(per_tile, 0)
    dev = proj.mx.device
    max_slots = (valid.sum(dim=0).max() if proj.mx.shape[0]
                 else torch.zeros((), dtype=torch.int64, device=dev))
    stats = torch.stack([clipped.sum(), max_slots, tile_end[-1],
                         per_tile.max()]).to(torch.int64)
    return TileCounts((tile_end - per_tile).to(torch.int32),
                      tile_end.to(torch.int32), stats)


def bin_place_plain(proj: ProjectedCols, opacities: torch.Tensor,
                    tile_start: torch.Tensor, num_pairs: int,
                    tile_size: int, tiles_x: int, tiles_y: int, kmax: int,
                    parent_major: bool = False) -> torch.Tensor:
    """What `bin_place` computes: keys [P] int64 (uint64 bits) in tile
    segments, here in emission order (j-major) within a segment."""
    num_tiles = tiles_x * tiles_y
    tile_of_slot, _ = slot_tiles(proj, opacities, tile_size, tiles_x,
                                 tiles_y, kmax, parent_major)
    flat = tile_of_slot.reshape(-1)
    slot = torch.nonzero(flat < num_tiles).squeeze(1)  # j * N + n
    tile = flat[slot].to(torch.int64)
    n = proj.mx.shape[0]
    bits = proj.depth[slot % max(n, 1)].contiguous().view(torch.int32)
    key = ((bits.to(torch.int64) & 0xFFFFFFFF) << 32) | slot
    keys = key[torch.argsort(tile, stable=True)]
    if keys.shape[0] != num_pairs:
        raise ValueError(f"{num_pairs} pairs counted, {keys.shape[0]} "
                         "placed")
    return keys


def sort_segments_plain(keys: torch.Tensor, tile_start: torch.Tensor,
                        tile_end: torch.Tensor) -> torch.Tensor:
    """The keys of each segment [tile_start, tile_end) in ascending
    uint64 order (the keys bin_sort_tiles works from)."""
    seg = torch.repeat_interleave(
        torch.arange(tile_start.shape[0], device=keys.device),
        (tile_end - tile_start).to(torch.int64))
    order = torch.argsort(keys ^ _SIGN, stable=True)
    return keys[order[torch.argsort(seg[order], stable=True)]]


def mask_words(kmax: int) -> int:
    """Words of the slot mask a gaussian has at `kmax` slot ranks."""
    return -(-kmax // MASK_BITS)


def pack_slot_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, kmax] bool -> the slot mask [ceil(kmax / 32), N] int32 (bit
    j % 32 of word j // 32)."""
    n, kmax = bits.shape
    words = mask_words(kmax)
    padded = bits.new_zeros((n, words * MASK_BITS))
    padded[:, :kmax] = bits
    weight = 2 ** torch.arange(MASK_BITS, dtype=torch.int64,
                               device=bits.device)
    packed = (padded.view(n, words, MASK_BITS).to(torch.int64)
              * weight).sum(dim=2)  # < 2^32: the word's bits, unsigned
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32).T.contiguous()


def slot_bits(slot_mask: torch.Tensor, kmax: int) -> torch.Tensor:
    """The slot mask [ceil(kmax / 32), N] as [N, kmax] bool: whether slot
    rank j of gaussian n holds a record."""
    j = torch.arange(kmax, device=slot_mask.device)
    words = slot_mask[j // MASK_BITS].T  # [N, kmax]
    return (words >> (j % MASK_BITS).to(torch.int32)) & 1 != 0


def defined_slot_pos(binned) -> torch.Tensor:
    """A binning's slot map with -1 outside its mask: the part of the map
    that is defined."""
    return torch.where(slot_bits(binned.slot_mask, binned.slot_pos.shape[1]),
                       binned.slot_pos, -1)


def binning_diff(got, want) -> list:
    """The fields in which two binnings (BinnedGaussians, or
    bin_sort_tiles' SortedTiles) differ: every field compared bit for bit
    with its dtype and shape, the slot map only under the mask (the mask
    itself bit for bit).  Empty when they agree."""
    diff = []
    for name, a, b in zip(want._fields, got, want):
        if name == "slot_pos":
            a, b = defined_slot_pos(got), defined_slot_pos(want)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            diff.append(name)
    return diff


def bin_sort_tiles_plain(keys: torch.Tensor, tile_start: torch.Tensor,
                         tile_end: torch.Tensor, proj: ProjectedCols,
                         colors: torch.Tensor, opacities: torch.Tensor,
                         kmax: int) -> SortedTiles:
    """What `bin_sort_tiles` computes: records [9, P], gauss_id [P],
    slot_pos [N, kmax] (-1 outside the mask here) and slot_mask from each
    segment's keys in ascending uint64 order."""
    n = proj.mx.shape[0]
    dev = keys.device
    slot = sort_segments_plain(keys, tile_start, tile_end) & 0xFFFFFFFF
    gid = slot % max(n, 1)  # slot = j * N + n
    rank = slot // max(n, 1)
    slot_pos = torch.full((n, kmax), -1, dtype=torch.int32, device=dev)
    slot_pos[gid, rank] = torch.arange(slot.shape[0], dtype=torch.int32,
                                       device=dev)
    op = opacities.to(torch.float32)
    cols = torch.stack([proj.mx, proj.my, proj.ca, proj.cb, proj.cc, op,
                        colors[:, 0], colors[:, 1],
                        colors[:, 2]]).to(torch.float32)
    records = cols.index_select(1, gid).contiguous()
    return SortedTiles(records, gid, slot_pos, pack_slot_bits(slot_pos >= 0))


# ---------------------------------------------------------------------
# the kernels' wrappers


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _columns(proj: ProjectedCols, opacities: torch.Tensor):
    """(mx, my, ca, cb, cc, op, radius, depth) as contiguous float32."""
    return tuple(t.to(torch.float32).contiguous() for t in (
        proj.mx, proj.my, proj.ca, proj.cb, proj.cc, opacities,
        proj.radius, proj.depth))


def _check(name: str, proj: ProjectedCols, tile_size: int, tiles_x: int,
           kmax: int, parent_major: bool) -> bool:
    """Whether the call runs on the card (else on the CPU); raises on
    what the kernels do not take."""
    dev = proj.mx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    n = proj.mx.shape[0]
    if kmax < 1 or kmax * n >= MAX_SLOTS:
        raise ValueError(f"{name}: kmax * N = {kmax} * {n} must be in "
                         f"[1, 2^31): a key's low word is the int32 slot "
                         "index j * N + n")
    if tile_size & (tile_size - 1) or tile_size < 1:
        raise ValueError(f"{name}: the tile size must be a power of two, "
                         f"got {tile_size}")
    if parent_major and tiles_x % 2:
        raise ValueError(f"{name}: parent-major ranks need an even "
                         f"tiles_x, got {tiles_x}")
    return dev.type == "cuda"


def bin_count(proj: ProjectedCols, opacities: torch.Tensor, tile_size: int,
              tiles_x: int, tiles_y: int, kmax: int,
              parent_major: bool = False) -> TileCounts:
    """The pairs per tile as segment offsets (tile_start, tile_end) and
    the counters (num_clipped, max_slots, pairs, longest segment)."""
    if not _check(COUNT_KERNEL, proj, tile_size, tiles_x, kmax,
                  parent_major):
        return bin_count_plain(proj, opacities, tile_size, tiles_x, tiles_y,
                               kmax, parent_major)
    dev = proj.mx.device
    cols = _columns(proj, opacities)
    num_tiles = tiles_x * tiles_y
    scratch = torch.zeros(4 + num_tiles, dtype=torch.int32, device=dev)
    start = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    end = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int64, device=dev)
    fn = cuda_lib.function(COUNT_KERNEL, (_P,) * 7 + (_L, _I, _I, _I, _I, _I)
                 + (_P,) * 5)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in cols[:7]), proj.mx.shape[0],
                 tile_size, tiles_x, tiles_y, kmax, int(parent_major),
                 scratch.data_ptr(), start.data_ptr(), end.data_ptr(),
                 stats.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.launched(COUNT_KERNEL, err)
    return TileCounts(start, end, stats)


def bin_place(proj: ProjectedCols, opacities: torch.Tensor,
              tile_start: torch.Tensor, num_pairs: int, tile_size: int,
              tiles_x: int, tiles_y: int, kmax: int,
              parent_major: bool = False) -> torch.Tensor:
    """Keys [num_pairs] int64 (uint64 bits) in the segments `tile_start`
    begins."""
    if not _check(PLACE_KERNEL, proj, tile_size, tiles_x, kmax,
                  parent_major):
        return bin_place_plain(proj, opacities, tile_start, num_pairs,
                               tile_size, tiles_x, tiles_y, kmax,
                               parent_major)
    dev = proj.mx.device
    cols = _columns(proj, opacities)
    num_tiles = tiles_x * tiles_y
    if tile_start.shape != (num_tiles,) or tile_start.dtype != torch.int32:
        raise ValueError(f"tile_start must be [{num_tiles}] int32")
    cursor = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    keys = torch.empty(num_pairs, dtype=torch.int64, device=dev)
    fn = cuda_lib.function(PLACE_KERNEL, (_P,) * 8 + (_L, _I, _I, _I, _I, _I)
                 + (_P,) * 4)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in cols), proj.mx.shape[0], tile_size,
                 tiles_x, tiles_y, kmax, int(parent_major),
                 tile_start.contiguous().data_ptr(), cursor.data_ptr(),
                 keys.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.launched(PLACE_KERNEL, err)
    return keys


def bin_sort_tiles(keys: torch.Tensor, tile_start: torch.Tensor,
                   tile_end: torch.Tensor, longest: int,
                   proj: ProjectedCols, colors: torch.Tensor,
                   opacities: torch.Tensor, kmax: int) -> SortedTiles:
    """Records [9, P], gauss_id [P], slot_pos [N, kmax] and slot_mask
    from the keys of each segment in ascending order.  On the card the
    keys are overwritten, the map is left undefined outside the mask;
    `longest` is the longest segment (bin_count's)."""
    dev = keys.device
    if dev.type == "cpu":
        return bin_sort_tiles_plain(keys, tile_start, tile_end, proj,
                                    colors, opacities, kmax)
    if dev.type != "cuda":
        raise ValueError(f"{SORT_KERNEL}: unsupported device {dev}")
    n, pairs = proj.mx.shape[0], keys.shape[0]
    if kmax < 1 or kmax * n >= MAX_SLOTS:
        raise ValueError(f"{SORT_KERNEL}: kmax * N = {kmax} * {n} must be in "
                         "[1, 2^31)")
    if keys.dtype != torch.int64 or not keys.is_contiguous() or any(
            t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev
            for t in (tile_start, tile_end)):
        raise ValueError(f"{SORT_KERNEL} takes contiguous int64 keys and "
                         "int32 tile ranges on one card")
    cols = _columns(proj, opacities)[:6]
    rgb = colors.to(torch.float32).contiguous()
    records = torch.empty((NUM_REC, pairs), dtype=torch.float32, device=dev)
    gid = torch.empty(pairs, dtype=torch.int64, device=dev)
    slot_pos = torch.empty((n, kmax), dtype=torch.int32, device=dev)
    slot_mask = torch.empty((mask_words(kmax), n), dtype=torch.int32,
                            device=dev)  # zeroed by the C function
    num_tiles = tile_start.shape[0]
    chunk = cuda_lib.function(SORT_KERNEL, (), "bin_sort_tiles_chunk")()
    # the tiles longer than a sorting block's chunk, listed by the kernel
    # (a count, then the tiles), and the merge's second key buffer
    max_long = min(num_tiles, pairs // (chunk + 1)) if longest > chunk else 0
    listed, merged = ((torch.empty(1 + max_long, dtype=torch.int32,
                                   device=dev),
                       torch.empty(pairs, dtype=torch.int64, device=dev))
                      if max_long else (None, None))
    fn = cuda_lib.function(SORT_KERNEL, (_P, _P, _P, _I, _L) + (_P,) * 7
                           + (_L, _I, _L) + (_P,) * 5 + (_I, _P, _P))
    with torch.cuda.device(dev):
        err = fn(keys.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
                 num_tiles, longest, *(t.data_ptr() for t in cols),
                 rgb.data_ptr(), n, kmax, pairs, records.data_ptr(),
                 gid.data_ptr(), slot_pos.data_ptr(), slot_mask.data_ptr(),
                 None if listed is None else listed.data_ptr(), max_long,
                 None if merged is None else merged.data_ptr(),
                 cuda_lib.stream(dev))
    cuda_lib.launched(SORT_KERNEL, err)
    return SortedTiles(records, gid, slot_pos, slot_mask)


def _binned(counts: TileCounts, out: SortedTiles) -> BinnedGaussians:
    return BinnedGaussians(
        records=out.records, gauss_id=out.gauss_id,
        tile_start=counts.tile_start, tile_end=counts.tile_end,
        num_clipped=counts.stats[0], max_slots=counts.stats[1],
        slot_pos=out.slot_pos, slot_mask=out.slot_mask)


def bin_gaussians(proj: ProjectedCols, colors: torch.Tensor,
                  opacities: torch.Tensor, tile_size: int, tiles_x: int,
                  tiles_y: int, kmax: int = 12,
                  parent_major: bool = False) -> BinnedGaussians:
    """Bin projected gaussians into depth-ordered per-tile segments.
    colors [N,3], opacities [N]; gaussians with radius 0 emit nothing.
    `parent_major` ranks each gaussian's slots in v3's parent-major tile
    order."""
    geo = (tile_size, tiles_x, tiles_y, kmax, parent_major)
    counts = bin_count(proj, opacities, *geo)
    num_pairs, longest = counts.stats[2:].tolist()  # the one read-back
    keys = bin_place(proj, opacities, counts.tile_start, num_pairs, *geo)
    return _binned(counts, bin_sort_tiles(
        keys, counts.tile_start, counts.tile_end, longest, proj, colors,
        opacities, kmax))


def bin_gaussians_plain(proj: ProjectedCols, colors: torch.Tensor,
                        opacities: torch.Tensor, tile_size: int,
                        tiles_x: int, tiles_y: int, kmax: int = 12,
                        parent_major: bool = False) -> BinnedGaussians:
    """`bin_gaussians` through the plain versions on any device: the
    kernels' reference, equal to their BinnedGaussians bit for bit."""
    geo = (tile_size, tiles_x, tiles_y, kmax, parent_major)
    counts = bin_count_plain(proj, opacities, *geo)
    keys = bin_place_plain(proj, opacities, counts.tile_start,
                           int(counts.stats[2]), *geo)
    return _binned(counts, bin_sort_tiles_plain(
        keys, counts.tile_start, counts.tile_end, proj, colors, opacities,
        kmax))
