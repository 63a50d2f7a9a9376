"""The binning kernels' plain versions (splatco_torch/ops/binning.py:
bin_count, bin_place, bin_sort_tiles; ops/rasterize.py: slot_reduce) on
the CPU, which is what their wrappers take for CPU tensors.

Composed, the split plain versions must give exactly the binning the port
had before the kernels (`binning_before` below: every slot emitted
j-major, one stable int64 argsort of `tile << 32 | depth_bits`), field for
field, and the same segments as JAX `bin_gaussians` / `bin_gaussians_v3`
(as tests/test_torch_raster.py and test_torch_raster_v3.py hold them).
Scenes: the existing ones (the `clipped` one among them), the offsets of
anchors at one point (depth ties), every gaussian inside one tile (a
segment longer than the 4096 keys a sorting block holds on the card), and
N = 0; kmax 12, 32 and 40.  The card's kernels are held to these plain
versions bit for bit in tests/test_torch_gpu.py and chip_smoke.py's
phase 21.

The slot mask (bit j % 32 of word j // 32 of gaussian n: slot rank j of n
holds a record) is the -1 pattern of the dense [kmax, N] map the binning
had before it, and the gaussian-major map [N, kmax] is that map
transposed under the mask; `binning.binning_diff` compares two binnings
so (the card leaves the map undefined outside the mask).

The reduce sums each gaussian's slots j = 0 .. kmax-1 in order, from
+0.0, adding +0.0 for an empty slot: held bit for bit to a numpy float32
loop in that order over the old dense map, whatever the map holds
outside the mask, and to a float64 sum at the existing tolerances.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_raster import SCENES as V2_SCENES
from test_torch_raster import both_cols
from test_torch_raster_v3 import jax_segment, tied_scene

from splatco_torch.ops import binning as t_bin
from splatco_torch.ops import cuda_lib
from splatco_torch.ops import raster_v3 as t_v3
from splatco_torch.ops import rasterize as t_ras
from splatco_torch.ops.projection import ProjectedCols as TCols
from splatco_tpu.ops import binning as j_bin
from splatco_tpu.ops import raster_v3 as j_v3
from splatco_tpu.ops import rasterize_pallas as rp
from splatco_tpu.ops.projection import ProjectedCols as JCols

KMAXES = (12, 32, 40)


def binning_before(proj, colors, opacities, tile_size, tiles_x, tiles_y,
                   kmax, parent_major):
    """The port's binning before its kernels: the slot grid (ranked
    parent-major for v3), every valid slot emitted j-major, one stable
    argsort of `tile << 32 | depth_bits`, the slot map as the inverse of
    that permutation (int64 then, int32 now: the same values).  Returns
    (BinnedGaussians with that map gaussian-major, -1 outside the mask,
    and the mask built from the slot list; the dense [kmax, N] map)."""
    num_tiles = tiles_x * tiles_y
    tile_of_slot, clipped = t_bin.slot_tiles(proj, opacities, tile_size,
                                             tiles_x, tiles_y, kmax)
    if parent_major:
        tile_of_slot = t_v3.parent_major_slots(tile_of_slot, tiles_x,
                                               num_tiles)
    n = proj.mx.shape[0]
    valid = tile_of_slot < num_tiles
    max_slots = valid.sum(dim=0).max() if n else torch.zeros(
        (), dtype=torch.int64)
    slot = torch.nonzero(valid.reshape(-1)).squeeze(1)
    tile = tile_of_slot.reshape(-1)[slot].to(torch.int64)
    gid = slot % max(n, 1)
    depth_bits = proj.depth[gid].contiguous().view(torch.int32)
    key = (tile << 32) | depth_bits.to(torch.int64)
    order = torch.argsort(key, stable=True)
    gid = gid[order]
    tile = tile[order]
    slot_pos = torch.full((kmax * n,), -1, dtype=torch.int64)
    slot_pos[slot[order]] = torch.arange(order.shape[0])
    dense = slot_pos.to(torch.int32).reshape(kmax, n)  # int32 since PR 14
    words = -(-kmax // 32)
    mask = np.zeros((words, n), np.uint32)
    js, gs = slot.numpy() // max(n, 1), slot.numpy() % max(n, 1)
    np.bitwise_or.at(mask, (js // 32, gs),
                     np.left_shift(np.uint32(1), (js % 32).astype(np.uint32)))
    cols = torch.stack([proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                        opacities.to(torch.float32), colors[:, 0],
                        colors[:, 1], colors[:, 2]]).to(torch.float32)
    per_tile = torch.bincount(tile, minlength=num_tiles)
    tile_end = torch.cumsum(per_tile, 0)
    return t_bin.BinnedGaussians(
        records=cols.index_select(1, gid).contiguous(), gauss_id=gid,
        tile_start=(tile_end - per_tile).to(torch.int32),
        tile_end=tile_end.to(torch.int32), num_clipped=clipped.sum(),
        max_slots=max_slots, slot_pos=dense.T.contiguous(),
        slot_mask=torch.as_tensor(mask.view(np.int32))), dense


def cols_scene(mx, my, depth, ca, cb, cc, radius, seed, h, w):
    """A scene from columns (numpy): (JAX cols, colors, opacities, h, w)."""
    rng = np.random.default_rng(seed)
    n = len(mx)
    jcols = JCols(*(jnp.asarray(np.asarray(c, np.float32))
                    for c in (mx, my, depth, ca, cb, cc, radius)))
    colors = jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.2, 0.99, size=(n,)), jnp.float32)
    return jcols, colors, opac, h, w


def one_point(n=96, h=96, w=128):
    """Every gaussian at one point and one depth, with conics of several
    scales (the offsets of one anchor, all at its centre)."""
    rng = np.random.default_rng(11)
    s = rng.uniform(0.5, 8.0, n)
    return cols_scene(np.full(n, 50.3), np.full(n, 41.7), np.full(n, 2.5),
                      1 / s ** 2, np.zeros(n), 1 / s ** 2,
                      np.ceil(3 * s), 12, h, w)


def one_tile(n=4608, h=96, w=128):
    """Every gaussian inside 16 px tile (2, 2) (so 32 px tile (1, 1)),
    depths on a coarse grid (many ties): one segment longer than a
    sorting block's 4096 keys."""
    rng = np.random.default_rng(13)
    return cols_scene(rng.uniform(36.0, 44.0, n), rng.uniform(36.0, 44.0, n),
                      np.round(rng.uniform(1.0, 3.0, n), 1),
                      np.full(n, 0.4), rng.uniform(-0.05, 0.05, n),
                      np.full(n, 0.4), np.full(n, 3.0), 14, h, w)


def empty(h=64, w=96):
    return cols_scene(*([np.zeros(0)] * 7), 15, h, w)


def from_projection(make):
    def scene():
        proj, colors, opac, cam = make()[:4]
        jcols = both_cols(proj)[0]
        return jcols, colors, opac, cam.image_height, cam.image_width
    return scene


def from_v3(make):
    def scene():
        proj, colors, opac, h, w = make()
        return both_cols(proj)[0], colors, opac, h, w
    return scene


SCENES = {
    **{name: from_projection(make) for name, make in V2_SCENES.items()},
    "ties": from_v3(tied_scene),
    "one_point": one_point,
    "one_tile": one_tile,
    "empty": empty,
}
NEW = ("ties", "one_point", "one_tile")


def torch_scene(scene):
    jcols, colors, opac, h, w = SCENES[scene]()
    tcols = TCols(*(torch.as_tensor(np.array(c, np.float32)) for c in jcols))
    return (jcols, colors, opac, tcols, torch.as_tensor(np.array(colors)),
            torch.as_tensor(np.array(opac)), h, w)


def grid(tile16, h, w):
    return (t_v3.tile_grid if tile16 else t_ras.tile_grid)(h, w)


def assert_same(got, want):
    """binning_diff finds nothing, and the plain version's map holds -1
    outside the mask, as the reference's does."""
    assert t_bin.binning_diff(got, want) == []
    assert torch.equal(got.slot_pos, want.slot_pos)


@pytest.mark.parametrize("tile16", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("kmax", KMAXES)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_split_plain_equals_the_binning_before(scene, kmax, tile16):
    """bin_frame (wrappers -> plain versions on the CPU) and the plain
    composition give the binning before the kernels, field for field."""
    _, _, _, tcols, colors, opac, h, w = torch_scene(scene)
    tile = t_v3.TILE if tile16 else t_bin.TILE
    tiles_x, tiles_y = grid(tile16, h, w)
    want = binning_before(tcols, colors, opac, tile, tiles_x, tiles_y, kmax,
                          tile16)[0]
    got = t_ras.bin_frame(tcols, colors, opac, tile, h, w, kmax)[0]
    assert_same(got, want)
    assert_same(t_bin.bin_gaussians_plain(tcols, colors, opac, tile,
                                          tiles_x, tiles_y, kmax, tile16),
                want)
    if scene == "one_tile":
        assert int((got.tile_end - got.tile_start).max()) > 4096
    if scene == "empty":
        assert got.records.shape == (9, 0) and got.slot_pos.shape == (0, kmax)
        assert got.slot_mask.shape == (t_bin.mask_words(kmax), 0)


@pytest.mark.parametrize("kmax", KMAXES)
@pytest.mark.parametrize("scene", NEW)
def test_split_plain_matches_jax_binning(scene, kmax):
    """The 32 px segments hold JAX `bin_gaussians`' gaussians in its
    order, and the counters agree (as test_torch_raster.py holds the
    existing scenes)."""
    jcols, colors, opac, tcols, tcolors, topac, h, w = torch_scene(scene)
    tiles_x, tiles_y = grid(False, h, w)
    n = tcols.mx.shape[0]
    jb = j_bin.bin_gaussians(jcols, colors, opac, 32, tiles_x, tiles_y,
                             kmax=kmax, chunk=rp.CHUNK)
    tb = t_bin.bin_gaussians(tcols, tcolors, topac, 32, tiles_x, tiles_y,
                             kmax=kmax)
    gid = np.asarray(jb.slot_key) % n
    js, je = np.asarray(jb.tile_start), np.asarray(jb.tile_end)
    ts, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    for tile in range(tiles_x * tiles_y):
        assert gid[js[tile]:je[tile]].tolist() == \
            tb.gauss_id[ts[tile]:te[tile]].tolist(), tile
    assert int(tb.num_clipped) == int(jb.num_clipped)
    assert int(tb.max_slots) == int(jb.max_slots)
    assert tb.records.shape == (9, int(js[-1]))


@pytest.mark.parametrize("kmax", KMAXES)
@pytest.mark.parametrize("scene", NEW)
def test_split_plain_matches_jax_binning_v3(scene, kmax):
    """The 16 px segments hold JAX `bin_gaussians_v3`'s gaussians and
    record columns in its order, and the counters agree (as
    test_torch_raster_v3.py holds the existing scenes)."""
    jcols, colors, opac, tcols, tcolors, topac, h, w = torch_scene(scene)
    tiles_x, tiles_y = grid(True, h, w)
    n = tcols.mx.shape[0]
    jb = j_v3.bin_gaussians_v3(jcols, colors, opac, tiles_x, tiles_y,
                               kmax=kmax, class_spec=((kmax, n),))
    tb = t_v3.bin_gaussians_v3(tcols, tcolors, topac, tiles_x, tiles_y,
                               kmax=kmax)
    num_tiles = tiles_x * tiles_y
    js, je = jax_segment(jb, tiles_x, num_tiles)
    key = np.asarray(jb["slot_key"])
    packed = np.asarray(jb["packed"])
    ts, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    for t in range(num_tiles):
        assert tb.gauss_id[ts[t]:te[t]].tolist() == \
            (key[js[t]:je[t]] % n).tolist(), t
        np.testing.assert_array_equal(tb.records[:, ts[t]:te[t]].numpy(),
                                      packed[:9, js[t]:je[t]])
    assert tb.records.shape[1] == int(np.asarray(jb["t_start"])[num_tiles])
    assert int(tb.num_clipped) == int(jb["num_clipped"])
    assert int(tb.max_slots) == int(jb["max_slots"])


@pytest.mark.parametrize("seed", range(4))
def test_unique_key_order_is_the_stable_argsort(seed):
    """Within a tile, ascending float_bits(depth) << 32 | (j * N + n)
    orders pairs as the stable argsort of `tile << 32 | depth_bits` over
    the j-major emission, and sorting the segments of any placement of
    the keys gives one result."""
    rng = np.random.default_rng(seed)
    n, kmax, num_tiles = 500, 8, 7
    valid = rng.uniform(size=(kmax, n)) < 0.4
    tile = rng.integers(0, num_tiles, size=(kmax, n))
    depth = np.round(rng.uniform(0.5, 2.0, n), 1).astype(np.float32)
    slot = np.flatnonzero(valid)  # j-major emission: j * n + g
    tiles = tile.reshape(-1)[slot]
    bits = depth[slot % n].view(np.int32).astype(np.int64)
    want = slot[np.argsort((tiles << 32) | bits, kind="stable")]
    key = torch.as_tensor((bits << 32) | slot)
    per_tile = np.bincount(tiles, minlength=num_tiles)
    end = torch.as_tensor(np.cumsum(per_tile), dtype=torch.int32)
    start = end - torch.as_tensor(per_tile, dtype=torch.int32)
    placed = key[torch.as_tensor(np.argsort(tiles, kind="stable"))]
    # the same keys, shuffled within each segment (a kernel's placement)
    shuffled = placed.clone()
    for s, e in zip(start.tolist(), end.tolist()):
        shuffled[s:e] = placed[s:e][torch.as_tensor(rng.permutation(e - s),
                                                    dtype=torch.int64)]
    proj = TCols(*(torch.as_tensor(rng.uniform(size=n).astype(np.float32))
                   for _ in range(7)))
    colors = torch.as_tensor(rng.uniform(size=(n, 3)).astype(np.float32))
    opac = torch.as_tensor(rng.uniform(size=n).astype(np.float32))
    outs = [t_bin.bin_sort_tiles_plain(k, start, end, proj, colors, opac,
                                       kmax) for k in (placed, shuffled)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    records, gid, slot_pos, slot_mask = outs[0]
    np.testing.assert_array_equal(gid.numpy(), want % n)
    flat = slot_pos.T.reshape(-1).numpy()  # j-major, as the keys count
    np.testing.assert_array_equal(flat[want], np.arange(len(want)))
    assert (flat[np.setdiff1d(np.arange(kmax * n), slot)] == -1).all()
    np.testing.assert_array_equal(
        t_bin.slot_bits(slot_mask, kmax).T.reshape(-1).numpy(),
        valid.reshape(-1))
    np.testing.assert_array_equal(records[2].numpy(), proj.ca.numpy()[gid])


def test_keys_order_as_unsigned():
    """The plain sort takes keys as uint64, as the kernel does: a key with
    its top bit set comes after every other of its tile."""
    keys = torch.tensor([-(2 ** 63) + 5, 7, 3], dtype=torch.int64)
    start, end = torch.tensor([0], dtype=torch.int32), torch.tensor(
        [3], dtype=torch.int32)
    proj = TCols(*(torch.arange(8, dtype=torch.float32) for _ in range(7)))
    _, gid, slot_pos, slot_mask = t_bin.bin_sort_tiles_plain(
        keys, start, end, proj, torch.zeros(8, 3), torch.ones(8), 1)
    assert gid.tolist() == [3, 7, 5]
    assert slot_pos[[3, 7, 5], 0].tolist() == [0, 1, 2]
    assert slot_mask.tolist() == [[0, 0, 0, 1, 0, 1, 0, 1]]


@pytest.mark.parametrize("tile16", [False, True], ids=["v2", "v3"])
def test_wrappers_on_cpu_take_the_plain_versions(tile16, monkeypatch):
    """Each wrapper runs its plain version for CPU tensors and never
    loads a kernel."""
    called = []

    def no_kernel(name):
        raise AssertionError(f"{name} loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", no_kernel)
    for name in ("bin_count_plain", "bin_place_plain",
                 "bin_sort_tiles_plain"):
        real = getattr(t_bin, name)

        def spy(*a, _real=real, _name=name, **kw):
            called.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(t_bin, name, spy)
    real_reduce = t_ras.reduce_slots_plain

    def reduce_spy(*a):
        called.append("reduce_slots_plain")
        return real_reduce(*a)
    monkeypatch.setattr(t_ras, "reduce_slots_plain", reduce_spy)
    _, _, _, tcols, colors, opac, h, w = torch_scene("n128_64x96")
    tile = t_v3.TILE if tile16 else t_bin.TILE
    before = dict(cuda_lib.LAUNCHES)
    binned = t_ras.bin_frame(tcols, colors, opac, tile, h, w, 12)[0]
    t_ras.reduce_slots(torch.ones((9, binned.records.shape[1])),
                       binned.slot_pos, binned.slot_mask)
    assert called == ["bin_count_plain", "bin_place_plain",
                      "bin_sort_tiles_plain", "reduce_slots_plain"]
    assert dict(cuda_lib.LAUNCHES) == before


def test_wrappers_raise_where_there_is_no_kernel():
    """Off the CPU and without a card (a meta tensor) each wrapper
    raises, as it does above its caps (kmax * N < 2^31, power-of-two
    tiles, an even parent grid for v3's ranks): none falls back to a
    plain version."""
    _, _, _, tcols, colors, opac, h, w = torch_scene("n128_64x96")
    meta = TCols(*(c.to("meta") for c in tcols))
    tiles_x, tiles_y = grid(False, h, w)
    counts = t_bin.bin_count_plain(tcols, opac, 32, tiles_x, tiles_y, 12)
    with pytest.raises(ValueError, match="unsupported device"):
        t_bin.bin_count(meta, opac.to("meta"), 32, tiles_x, tiles_y, 12)
    with pytest.raises(ValueError, match="unsupported device"):
        t_bin.bin_place(meta, opac.to("meta"), counts.tile_start.to("meta"),
                        10, 32, tiles_x, tiles_y, 12)
    with pytest.raises(ValueError, match="unsupported device"):
        t_bin.bin_sort_tiles(torch.zeros(3, dtype=torch.int64,
                                         device="meta"),
                             counts.tile_start.to("meta"),
                             counts.tile_end.to("meta"), 3, meta,
                             colors.to("meta"), opac.to("meta"), 12)
    with pytest.raises(ValueError, match="takes"):
        t_ras.reduce_slots(torch.zeros((9, 4), device="meta"),
                           torch.zeros((5, 12), dtype=torch.int32,
                                       device="meta"),
                           torch.zeros((1, 5), dtype=torch.int32,
                                       device="meta"))
    n = tcols.mx.shape[0]
    with pytest.raises(ValueError, match="2\\^31"):
        t_bin.bin_count(tcols, opac, 32, tiles_x, tiles_y, 2 ** 31 // n + 1)
    with pytest.raises(ValueError, match="power of two"):
        t_bin.bin_count(tcols, opac, 24, tiles_x, tiles_y, 12)
    with pytest.raises(ValueError, match="even tiles_x"):
        t_bin.bin_place(tcols, opac, counts.tile_start, 10, 16, 5, 4, 12,
                        parent_major=True)


def test_shared_tiles_matches_the_kernels():
    """binning.SHARED_TILES, which the card tests and chip_smoke.py's
    wide frames pass to reach the global-atomic counting, is the kernels'
    kSharedTiles; its int32 histogram fits the 227 KiB of shared memory a
    Hopper block may ask for, with room for the kernel's static shared
    memory; bin_count forks on it, and bin_place, which keeps no
    histogram, has one path for every grid."""
    csrc = Path(t_bin.__file__).resolve().parent.parent / "csrc"
    header = (csrc / "binning.cuh").read_text()
    assert re.search(r"constexpr int kSharedTiles = (\d+);",
                     header).group(1) == str(t_bin.SHARED_TILES)
    assert 4 * t_bin.SHARED_TILES <= 232448 - 1024
    # v3 at 3840x2160 counts in shared memory, v3 at 7680x4320 does not
    assert 240 * 136 <= t_bin.SHARED_TILES < 480 * 270
    count = (csrc / "bin_count.cu").read_text()
    assert "g.num_tiles <= binning::kSharedTiles" in count
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in count
    place = (csrc / "bin_place.cu").read_text()
    assert "kSharedTiles" not in place and "extern __shared__" not in place


def reduce_in_order(per_record, slot_pos):
    """numpy float32: each row summed over j = 0 .. kmax-1 in order."""
    acc = np.zeros((per_record.shape[0], slot_pos.shape[1]), np.float32)
    for pos in slot_pos:
        acc = acc + np.where(pos >= 0, per_record[:, np.maximum(pos, 0)],
                             np.float32(0.0))
    return acc


def clipped_binning(kmax, tile16=False):
    """The `clipped` scene binned through the wrappers (the plain versions
    on the CPU) and by `binning_before`: (binned, the dense map before)."""
    _, _, _, tcols, colors, opac, h, w = torch_scene("clipped")
    tile = t_v3.TILE if tile16 else t_bin.TILE
    tiles_x, tiles_y = grid(tile16, h, w)
    binned = t_ras.bin_frame(tcols, colors, opac, tile, h, w, kmax)[0]
    dense = binning_before(tcols, colors, opac, tile, tiles_x, tiles_y, kmax,
                           tile16)[1]
    return binned, dense


@pytest.mark.parametrize("tile16", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("kmax", KMAXES)
def test_slot_mask_is_the_dense_maps_pattern(kmax, tile16):
    """The slot mask has exactly the bits where the dense [kmax, N] map of
    the binning before held a record (kmax 40: two words a gaussian), and
    the gaussian-major map under it holds that map's positions."""
    binned, dense = clipped_binning(kmax, tile16)
    n = dense.shape[1]
    assert binned.slot_mask.shape == (t_bin.mask_words(kmax), n)
    held = t_bin.slot_bits(binned.slot_mask, kmax)
    assert torch.equal(held, (dense >= 0).T)
    assert torch.equal(t_bin.pack_slot_bits((dense >= 0).T),
                       binned.slot_mask)
    assert torch.equal(t_bin.defined_slot_pos(binned), dense.T)
    if kmax > 32:
        assert binned.slot_mask[1].any()  # ranks past 31 are used
    assert int(held.sum()) == binned.records.shape[1]


def test_mask_helpers():
    """pack_slot_bits and slot_bits invert each other at every bit, 31
    (the int32 sign) among them; binning_diff ignores what the map holds
    outside the mask and finds a changed bit or a changed entry under
    it."""
    rng = np.random.default_rng(5)
    bits = torch.as_tensor(rng.uniform(size=(50, 40)) < 0.5)
    bits[0] = True
    mask = t_bin.pack_slot_bits(bits)
    assert mask.dtype == torch.int32 and mask.shape == (2, 50)
    assert int(mask[0, 0]) == -1 and int(mask[1, 0]) == 2 ** 8 - 1
    assert torch.equal(t_bin.slot_bits(mask, 40), bits)
    binned, _ = clipped_binning(32)
    junk = torch.where(t_bin.slot_bits(binned.slot_mask, 32),
                       binned.slot_pos, 12345)
    assert t_bin.binning_diff(binned._replace(slot_pos=junk), binned) == []
    g, j = (int(i[0]) for i in torch.nonzero(binned.slot_pos >= 0)[:1].T)
    moved = binned.slot_pos.clone()
    moved[g, j] += 1
    assert t_bin.binning_diff(binned._replace(slot_pos=moved),
                              binned) == ["slot_pos"]
    one = torch.zeros_like(binned.slot_pos, dtype=torch.bool)
    one[g, j] = True
    flipped = binned.slot_mask ^ t_bin.pack_slot_bits(one)
    assert t_bin.binning_diff(binned._replace(slot_mask=flipped),
                              binned) == ["slot_pos", "slot_mask"]


@pytest.mark.parametrize("kmax", KMAXES)
def test_reduce_reads_only_under_the_mask(kmax):
    """reduce_slots_plain over the mask equals the dense map's j-order
    loop bit for bit, -0.0 records included, whatever the map holds
    outside the mask (there the card leaves it unfilled)."""
    binned, dense = clipped_binning(kmax)
    rng = np.random.default_rng(100 + kmax)
    pairs = binned.records.shape[1]
    per_rec = rng.normal(size=(9, pairs)).astype(np.float32)
    per_rec[:, ::3] = -0.0
    junk = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1,
                                        size=binned.slot_pos.shape),
                           dtype=torch.int32)
    held = t_bin.slot_bits(binned.slot_mask, kmax)
    slot_pos = torch.where(held, binned.slot_pos, junk)
    got = t_ras.reduce_slots_plain(torch.as_tensor(per_rec), slot_pos,
                                   binned.slot_mask)
    want = reduce_in_order(per_rec, dense.numpy())
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("kmax", KMAXES)
def test_reduce_sums_the_slots_in_order(kmax):
    """reduce_slots (its plain version here) adds each gaussian's slots in
    order, bit for bit with a numpy float32 loop; a gaussian whose records
    are all -0.0 sums to +0.0 (0.0 + -0.0); it stays within the existing tolerance of a float64
    sum; an empty binning gives zeros."""
    _, _, _, tcols, colors, opac, h, w = torch_scene("clipped")
    binned = t_ras.bin_frame(tcols, colors, opac, t_bin.TILE, h, w, kmax)[0]
    rng = np.random.default_rng(kmax)
    pairs = binned.records.shape[1]
    per_rec = rng.normal(size=(9, pairs)).astype(np.float32)
    pos = t_bin.defined_slot_pos(binned).numpy().T  # the dense layout
    zero = np.flatnonzero((pos >= 0).any(axis=0))[0]
    per_rec[:, pos[:, zero][pos[:, zero] >= 0]] = -0.0
    got = t_ras.reduce_slots(torch.as_tensor(per_rec), binned.slot_pos,
                             binned.slot_mask)
    want = reduce_in_order(per_rec, pos)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert (got[:, zero].numpy().view(np.int32) == 0).all()  # +0.0
    exact = np.zeros((9, pos.shape[1]))
    np.add.at(exact.T, binned.gauss_id.numpy(),
              per_rec.T.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5,
                               atol=1e-6 * np.abs(exact).max())
    zeros = t_ras.reduce_slots(
        torch.zeros((9, 0)), torch.full((6, kmax), -1, dtype=torch.int32),
        torch.zeros((t_bin.mask_words(kmax), 6), dtype=torch.int32))
    assert zeros.shape == (9, 6) and not zeros.any()
