"""splatco_torch's probes (ops/probes.py) and its 16 px forward ablation
(ops/raster_ablate.py) on the CPU, where the wrappers take their plain
versions, against what the JAX tools they port check
(tools/micro_mosaic.py, tools/profile_kernel_v3.py) and against JAX v3's
forward; plus both port tools run as a user runs them.

Inputs are the JAX tool's own, drawn from np.random.default_rng(0) in its
order (`micro_mosaic_torch.inputs`).  Tolerances: the window row sums at
the JAX tool's 1e-4 (measured 5.72e-6, numpy sums pairwise, the probe in
32 lanes); the cumsum exact against numpy's float32 running sum (held to
1e-6 of the max); the alpha-sum probe at 1e-5 of the max against float64
numpy; the ablation bit for bit against the port's forward and at 1e-5
against JAX's, as tests/test_torch_raster_v3.py.  The card's cases
(chip_smoke.py's accumulation views 0-3 floats into larger buffers and
alpha-sum windows below 0 and past the width, the raw tool inputs' inf
and NaN sums) run here on the plain versions against numpy float32
loops; `accum_plan` must take every element once, its vectors 16 B
aligned; `measure.bound` takes the largest of bytes, fp32 operations and
the special-function unit's exps.  `accumulate_` refuses views that
overlap.  The cumsum's meaning is the JAX tool's `cs_kernel` (L x in
interpret mode, at both precisions), bit for bit with NaN at the same
positions on the card's cases, inf and NaN rows among them; the
extraction kernel's lane layouts (the shfl mode's four shuffle rounds,
the butterfly split between rows) restated in numpy equal the plain
version bit for bit.
"""
import os
import re
import subprocess
import sys

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_raster_v3 import ATOL, both_binnings, untile16
from test_torch_render import REPO

from chip_smoke import (ACCUM_OFFSETS, ACCUM_SIZES, ACCUM_STEP_COUNTS,
                        accum_case, accum_differs, accum_overlaps,
                        blend_cases, cumsum_cases, cumsum_differs,
                        extract_cases, same_floats_or_nan)
from splatco_torch.ops import probes, raster_ablate
from splatco_torch.ops.rasterize_cuda import raster_fwd_plain
from splatco_torch.utils import measure
from splatco_tpu.ops import raster_v3 as j_v3
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.join(REPO, "tools"))
import micro_mosaic_torch as mm  # noqa: E402
import profile_torch_kernel_v3 as pk  # noqa: E402

# the JAX tool sets a compilation cache directory of its own; keep it off
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
           JAX_ENABLE_COMPILATION_CACHE="false")


@pytest.fixture(scope="module")
def tool_inputs():
    return mm.inputs()


@pytest.mark.parametrize("mode", probes.EXTRACT_MODES)
def test_extract_rows_match_tool_expectation(tool_inputs, mode):
    """Every mode's row sums against the JAX tool's `expected()` on its
    inputs; rows 1-7 of each chunk are zero."""
    data = torch.as_tensor(tool_inputs["data"])
    got = probes.extract_rows(data, torch.as_tensor(tool_inputs["starts"]),
                              mode).numpy()
    assert got.shape == (mm.N_CHUNKS, probes.OUT_ROWS, probes.REC)
    want = mm.expected_row_sums(tool_inputs["data"], tool_inputs["starts"])
    assert np.abs(got[:, 0] - want).max() <= mm.EXTRACT_TOL
    assert not got[:, 1:].any()


def test_extract_rows_at_block_edges():
    """Windows at p % 128 = 0 and 127, the last one that fits, and one
    running past the array (those columns read 0), against float64
    sums."""
    data = np.random.default_rng(4).normal(size=(16, 1024)).astype(
        np.float32)
    starts = np.array([0, 127, 128, 255, 767, 768, 896, 1000], np.int32)
    got = probes.extract_rows(torch.as_tensor(data),
                              torch.as_tensor(starts)).numpy()
    want = np.stack([data[:, p:p + 128].astype(np.float64).sum(axis=1)
                     for p in starts])
    np.testing.assert_allclose(got[:, 0], want, rtol=0, atol=1e-5)


def test_extract_rows_add_in_the_kernels_order(tool_inputs):
    """The plain version adds as the kernel does (lane l: columns l + 32 j
    in order; then an xor butterfly), bit for bit in float32: what lets
    the card check hold every mode to it exactly."""
    data, starts = tool_inputs["data"], tool_inputs["starts"]
    got = probes.extract_rows_plain(torch.as_tensor(data),
                                    torch.as_tensor(starts)).numpy()[:, 0]
    for c, p in enumerate(starts.tolist()):
        w = data[:, p:p + 128].reshape(16, 4, 32)
        s = (w[:, 0] + w[:, 1]) + w[:, 2]
        s = s + w[:, 3]
        for off in (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ off]
        np.testing.assert_array_equal(got[c], s[:, 0])


@pytest.mark.parametrize("mode", probes.CUMSUM_MODES)
def test_cumsum_rows_match_numpy(tool_inputs, mode):
    xs = tool_inputs["xs"]
    got = probes.cumsum_rows(torch.as_tensor(xs), mode).numpy()
    want = np.cumsum(xs, axis=0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def cs_kernel(x_ref, out_ref, *, prec):
    """The JAX tool's `cs_kernel` (tools/micro_mosaic.py:88), verbatim: it
    is defined inside the tool's main."""
    xk = x_ref[:]
    kk = xk.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (kk, kk), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (kk, kk), 1)
    L = (rows >= cols).astype(jnp.float32)   # inclusive cumsum
    out_ref[:] = jax.lax.dot_general(
        L.T, xk, (((0,), (0,)), ((), ())),
        precision=prec, preferred_element_type=jnp.float32)


CUMSUM_CASES = list(cumsum_cases(mm.inputs(), torch.device("cpu")))


@pytest.mark.parametrize("prec", ["DEFAULT", "HIGHEST"])
@pytest.mark.parametrize("case", [c for c in CUMSUM_CASES
                                  if not c.startswith("(")])
def test_cumsum_plain_is_the_jax_cs_kernel(tool_inputs, case, prec):
    """`cumsum_rows_plain` equals the reference's L x, run as the JAX tool
    runs it on the CPU (interpret mode), bit for bit, NaN where it is NaN,
    at the tool's [128, 256]: the running sum, and NaN above an inf or
    NaN in the same column.  (At other shapes XLA's CPU product adds in
    another order, so the seeded shapes are held to float64 instead.)"""
    x = cumsum_cases(tool_inputs, torch.device("cpu"))[case]
    with pltpu.force_tpu_interpret_mode():
        want = np.array(pl.pallas_call(
            functools.partial(cs_kernel,
                              prec=getattr(jax.lax.Precision, prec)),
            out_shape=jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32),
        )(jnp.asarray(x.numpy())))
    got = probes.cumsum_rows_plain(x)
    assert same_floats_or_nan(got, torch.as_tensor(want))
    if case == "inf, -inf and NaN rows":
        assert np.isnan(want).any() and np.isinf(want).any()


@pytest.mark.parametrize("case", CUMSUM_CASES)
def test_cumsum_rows_take_the_plain_version_on_the_cpu(tool_inputs, case):
    """Both modes of `cumsum_rows` are the plain version for a CPU tensor
    (what the card's check holds fp32 to bit for bit, tf32 at its
    non-finite positions), and the plain version's finite values are
    within 1e-6 of the max of a float64 cumsum."""
    x = cumsum_cases(tool_inputs, torch.device("cpu"))[case]
    plain = probes.cumsum_rows_plain(x)
    for mode in probes.CUMSUM_MODES:
        got = probes.cumsum_rows(x, mode)
        assert same_floats_or_nan(got, plain)
        assert cumsum_differs(got, x, mode) is None
    fin = torch.isfinite(plain)
    ref = torch.cumsum(x.double(), dim=0)[fin]
    assert float((plain[fin].double() - ref).abs().max()) <= 1e-6 * float(
        ref.abs().max())


def test_cumsum_rows_refuse_what_the_kernel_does_not_take():
    """At most CUMSUM_MAX_ROWS rows, as `csrc/probe_cumsum.cu` stages
    them, multiples of 16 both ways; on both devices."""
    src = open(os.path.join(REPO, "splatco_torch", "csrc",
                            "probe_cumsum.cu")).read()
    assert f"rows > {probes.CUMSUM_MAX_ROWS}" in src
    probes.cumsum_rows(torch.zeros((probes.CUMSUM_MAX_ROWS, 16)))
    for shape in ((probes.CUMSUM_MAX_ROWS + 16, 16), (24, 16), (16, 8)):
        with pytest.raises(ValueError, match="at most"):
            probes.cumsum_rows(torch.zeros(shape))


@pytest.mark.parametrize("pair", range(4))
def test_accumulate_refuses_overlapping_views(pair):
    """out and inp sharing bytes raise on both devices (the kernel reads
    inp once, the plain version after each add): one buffer twice, views
    one float apart either way, one view inside another."""
    out, inp = accum_overlaps(torch.device("cpu"))[pair]
    before = out.clone()
    with pytest.raises(ValueError, match="overlap"):
        probes.accumulate_(out, inp)
    assert torch.equal(out, before)


LANES = np.arange(32)


def col_values(row, cols):
    """row[cols], 0 outside [0, width)."""
    inside = (cols >= 0) & (cols < row.shape[0])
    return np.where(inside, row[np.clip(cols, 0, row.shape[0] - 1)],
                    np.float32(0))


def window_values(row, p):
    """[32, 4]: lane l's window columns p + l + 32 j of one row."""
    return col_values(row, p + LANES[:, None] + 32 * np.arange(4)[None, :])


def shfl_values(row, p):
    """[32, 4]: what the shfl mode of `csrc/probe_extract.cu` gives lane l
    as its columns j = 0..3: lane m loads columns 4m .. 4m+3 of the two
    aligned blocks, rotates each by m / 8, and in round t sends register
    t of block 0 if its column is at or past the window's start, else of
    block 1; lane l reads lane src_t(l) and puts the values back in
    column order by its own rotation."""
    block0 = p & ~127
    off = p - block0
    cols = block0 + 4 * LANES[:, None] + np.arange(4)[None, :]
    blocks = [col_values(row, c) for c in (cols, cols + 128)]  # lane m's
    sm = LANES >> 3
    rot = (np.arange(4)[None, :] + sm[:, None]) & 3
    b0, b1 = (b[LANES[:, None], rot] for b in blocks)
    u = LANES + off
    cl = ((u & 3) - (u >> 5)) & 3
    got = np.zeros((32, 4), np.float32)
    for t in range(4):
        src = 8 * (((u & 3) - t) & 3) + ((u & 31) >> 2)
        first = 4 * LANES + ((t + sm) & 3) >= off
        got[:, t] = np.where(first, b0[:, t], b1[:, t])[src]
    v = got[:, [0, 3, 2, 1]]
    return v[LANES[:, None], (np.arange(4)[None, :] + (4 - cl[:, None]) & 3)]


def split_butterfly(partials):
    """The kernel's butterfly over R rows' lane partials [R, 32] (R a power
    of 2): at offset 16, 8, ... a lane keeps the half of its rows its bit
    selects and adds its partner's partials of them, until it holds one;
    then the plain levels.  Returns [R]: row r from lane r << (5 - log2
    R)."""
    rows = partials.shape[0]
    held = [list(partials[:, lane]) for lane in range(32)]
    width, o = rows, 16
    while width > 1:
        half = width // 2
        held = [[np.float32((held[lane][h + half] if lane & o
                             else held[lane][h])
                            + (held[lane ^ o][h] if (lane ^ o) & o
                               else held[lane ^ o][h + half]))
                 for h in range(half)] for lane in range(32)]
        width, o = half, o // 2
    val = np.array([h[0] for h in held], np.float32)
    while o:
        val = val + val[LANES ^ o]
        o //= 2
    shift = 5 - int(np.log2(rows))
    return val[np.arange(rows) << shift]


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
def test_extract_lane_layouts_restate_the_plain_sums(rows):
    """The extraction kernel's arithmetic restated: lane l's four columns
    (read directly, or through the shfl mode's rounds), summed in order,
    then the butterfly split between `rows` rows, equal
    `extract_rows_plain` bit for bit at every offset modulo 128, below 0,
    at and past the width."""
    data = np.random.default_rng(3).normal(size=(16, 1000)).astype(
        np.float32)
    starts = np.array(list(range(0, 260, 3)) + [127, 128, -1, -5, -127,
                                                -128, -129, 871, 872, 873,
                                                999, 1000, 2 ** 31 - 1,
                                                -2 ** 31], np.int64)
    want = probes.extract_rows_plain(
        torch.as_tensor(data), torch.as_tensor(starts.astype(np.int32))
    ).numpy()[:, 0]
    for c, p in enumerate(starts.tolist()):
        for lane_values in (window_values, shfl_values):
            v = np.stack([lane_values(data[r], p) for r in range(16)])
            assert np.array_equal(v, np.stack(
                [window_values(data[r], p) for r in range(16)]))
            s = (v[:, :, 0] + v[:, :, 1]) + v[:, :, 2]
            s = s + v[:, :, 3]  # [16, 32]
            got = np.concatenate([split_butterfly(s[g:g + rows])
                                  for g in range(0, 16, rows)])
            np.testing.assert_array_equal(got.view(np.int32),
                                          want[c].view(np.int32))


def test_extract_rows_plain_on_the_card_cases(tool_inputs):
    """The card's cases for the row sums (chip_smoke.extract_cases, the
    8,192 windows cut to 48) on the plain version against float64 sums:
    the windows below 0 and at or past the width read 0 there, the rows
    of width 8,323 and the misaligned copy as any other."""
    for case, (data, starts) in extract_cases(tool_inputs,
                                              torch.device("cpu")).items():
        starts = starts[:48]
        got = probes.extract_rows_plain(data, starts).numpy()
        d = data.numpy().astype(np.float64)
        cols = starts.numpy().astype(np.int64)[:, None] + np.arange(128)
        inside = (cols >= 0) & (cols < d.shape[1])
        want = np.where(inside[:, None, :],
                        d[:, np.clip(cols, 0, d.shape[1] - 1)].transpose(
                            1, 0, 2), 0).sum(-1)
        np.testing.assert_allclose(got[:, 0], want, rtol=1e-6, atol=1e-5,
                                   err_msg=case)
        assert not got[:, 1:].any()


def test_accumulate_in_place_is_two():
    out = torch.zeros((8, 128))
    ret = probes.accumulate_(out, torch.ones((8, 128)))
    assert ret is out
    assert bool((out == 2.0).all())


@pytest.mark.parametrize("extract", probes.BLEND_MODES)
def test_alpha_sums_match_float64(tool_inputs, extract):
    """The first 48 chunks of the tool's 5d inputs with row 2 made
    positive (a negative row 2 overflows exp) against the formula in
    float64."""
    n = 48
    big = tool_inputs["big"][:, :(n + 1) * probes.WIN].copy()
    big[2] = np.abs(big[2])
    st2 = tool_inputs["st2"][:n]
    got = probes.alpha_sums(torch.as_tensor(big), torch.as_tensor(st2),
                            extract).numpy().reshape(n, probes.PIX)
    px = np.arange(probes.PIX, dtype=np.float64)
    col0 = st2 if extract else st2 // 128 * 128
    want = np.zeros((n, probes.PIX))
    for c in range(n):
        m, q, o = big[[0, 2, 5], col0[c]:col0[c] + 128].astype(np.float64)
        want[c] = (o[:, None] * np.exp(-0.5 * q[:, None]
                                       * (m[:, None] - px) ** 2)).sum(0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("offsets", ACCUM_OFFSETS)
@pytest.mark.parametrize("n", ACCUM_SIZES)
def test_accumulate_plain_on_the_card_cases(n, offsets):
    """The card's cases on the plain version: a view starting 0-3 floats
    into a larger buffer, updated in place and nowhere else, equal to a
    numpy float32 loop of ceil(steps / 2) rounded adds."""
    for steps in ACCUM_STEP_COUNTS:
        out, inp = accum_case(n, offsets, 7 * n + steps, torch.device("cpu"))
        want = out.numpy().copy()
        for _ in range((steps + 1) // 2):
            want = want + inp.numpy()
        assert accum_differs(out, inp, steps) == []
        np.testing.assert_array_equal(out.numpy(), want)


def plan_cover(in_addr, out_addr, n):
    """The elements and 16 B vectors `probe_accum`'s threads take under
    `accum_plan`, as the kernel maps its thread index i: i < nvec a
    vector from element head + 4 i, then the head's elements, then the
    tail's."""
    head, nvec, blocks = probes.accum_plan(in_addr, out_addr, n)
    taken, vectors = [], []
    for i in range(blocks * probes.ACCUM_THREADS):
        if i < nvec:
            vectors.append(head + 4 * i)
            taken += range(head + 4 * i, head + 4 * i + 4)
        elif i - nvec < n - 4 * nvec:
            j = i - nvec
            taken.append(j if j < head else j + 4 * nvec)
    return head, nvec, blocks, taken, vectors


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1024, 1025, 2053])
def test_accum_plan_covers_each_element_once(n):
    """At every pair of in / out offsets modulo 16 B: each element taken
    by one thread; where the offsets agree, every vector 16 B aligned in
    both buffers, at most 3 elements before the first and after the last;
    otherwise no vector; the grid the fewest blocks of ACCUM_THREADS that
    hold a thread a unit."""
    for a in range(0, 16, 4):
        for b in range(0, 16, 4):
            in_addr, out_addr = 4096 + a, 8192 + b
            head, nvec, blocks, taken, vectors = plan_cover(in_addr,
                                                            out_addr, n)
            assert sorted(taken) == list(range(n))
            units = nvec + n - 4 * nvec
            assert blocks == -(-units // probes.ACCUM_THREADS)
            if a != b:
                assert nvec == 0
                continue
            assert head <= 3 and n - head - 4 * nvec <= 3
            assert all((in_addr + 4 * e) % 16 == 0
                       and (out_addr + 4 * e) % 16 == 0 for e in vectors)


def test_accum_threads_match_the_kernel():
    src = open(os.path.join(REPO, "splatco_torch", "csrc",
                            "probe_accum.cu")).read()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) \
        == str(probes.ACCUM_THREADS)


def alpha_sums_numpy(data, starts, extract):
    """The alpha sums as a numpy float32 loop over each chunk's records,
    in the kernel's order (numpy's exp)."""
    out = np.zeros((len(starts), probes.PIX), np.float32)
    px = np.arange(probes.PIX, dtype=np.float32)
    width = data.shape[1]
    with np.errstate(over="ignore", invalid="ignore"):
        for c, p in enumerate(starts.tolist()):
            col0 = p if extract else p // probes.WIN * probes.WIN
            s = np.zeros(probes.PIX, np.float32)
            for k in range(probes.WIN):
                col = col0 + k
                m, q, o = (data[[0, 2, 5], col] if 0 <= col < width
                           else np.zeros(3, np.float32))
                dx = m - px
                t = np.float32(-0.5) * q * dx
                t = t * dx
                s = s + o * np.exp(t)
            out[c] = s
    return out


@pytest.mark.parametrize("extract", probes.BLEND_MODES)
def test_alpha_sums_plain_on_the_card_cases(tool_inputs, extract):
    """The card's cases on the plain version (the tool's raw inputs cut
    to their first 48 chunks) against a numpy float32 loop: NaN and inf
    at the same positions, every other sum to 1e-5 of the case's max
    (the two exps may differ in the last bit)."""
    dev = torch.device("cpu")
    cases = blend_cases(tool_inputs, dev)
    big, st2 = cases["the tool's inputs"]
    cases["the tool's inputs"] = (big[:, :49 * probes.WIN].contiguous(),
                                    st2[:48])
    del cases["the tool's inputs, |row 2|"]
    for case, (data, starts) in cases.items():
        got = probes.alpha_sums(data, starts, extract).reshape(
            len(starts), probes.PIX).numpy()
        want = alpha_sums_numpy(data.numpy(), starts.numpy(), extract)
        for flag in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(flag(got), flag(want), case)
        fin = np.isfinite(want)
        assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * max(
            np.abs(want[fin]).max(), 1e-30), case


def test_same_floats_or_nan():
    """The card's comparison of the alpha sums: NaN positions equal,
    everything else bit for bit (a signed zero too)."""
    t = torch.tensor
    assert same_floats_or_nan(t([np.nan, 1.0, -0.0, np.inf]),
                              t([np.nan, 1.0, -0.0, np.inf]))
    assert not same_floats_or_nan(t([0.0]), t([-0.0]))
    assert not same_floats_or_nan(t([np.nan]), t([1.0]))
    assert not same_floats_or_nan(t([1.0]), t([np.nan]))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its kernel on the card and its plain version on the
    CPU, and raises for any other device."""
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    starts = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.extract_rows(meta(16, 512), starts)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.cumsum_rows(meta(128, 256))
    with pytest.raises(ValueError, match="unsupported device"):
        probes.accumulate_(meta(8, 128), meta(8, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        probes.alpha_sums(meta(16, 512), starts, True)


def test_jax_micro_mosaic_passes_on_the_same_inputs():
    """The reference tool on the CPU (interpret mode): its cumsum is exact
    and its three extraction modes pass, with the row-sum error the
    port's probe shows on the same inputs."""
    res = subprocess.run([sys.executable, "tools/micro_mosaic.py",
                          "--device", "cpu"], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    rel = [float(v) for v in
           re.findall(r"cumsum-matmul prec=.*rel_err=(\S+)", res.stdout)]
    assert len(rel) == 2 and max(rel) <= 1e-6, res.stdout
    lines = re.findall(r"extract\[(\w+) *\]  max_err=(\S+)  (\w+)",
                       res.stdout)
    assert [m for m, _, _ in lines] == ["matmul", "roll", "dynslice"]
    assert all(ok == "OK" for _, _, ok in lines), res.stdout
    inp = mm.inputs()
    port = probes.extract_rows(torch.as_tensor(inp["data"]),
                               torch.as_tensor(inp["starts"])).numpy()
    err = np.abs(port[:, 0] - mm.expected_row_sums(inp["data"],
                                                   inp["starts"])).max()
    assert {e for _, e, _ in lines} == {f"{err:.2e}"}


def test_micro_mosaic_torch_runs_on_cpu():
    res = subprocess.run([sys.executable, "tools/micro_mosaic_torch.py",
                          "--device", "cpu"], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 6 and all("OK" in line for line in lines), lines


@pytest.mark.parametrize("scene", ["n512_96x128", "clipped"])
def test_ablation_full_is_the_forward(scene):
    """`full` (and `nostage`) equal the port's 16 px forward bit for bit
    and JAX `forward_pallas_v3` (interpret mode) to 1e-5 in the image."""
    jb, tb, _, tiles_x, tiles_y, h, w = both_binnings(scene, 32)
    args = (tb.records, tb.tile_start, tb.tile_end, tiles_x, tiles_y, h, w)
    rgb, t_fin = raster_ablate.raster_fwd16_ablate(*args, variant="full")
    p_rgb, p_t = raster_fwd_plain(*args, tile=16)
    assert torch.equal(rgb, p_rgb) and torch.equal(t_fin, p_t)
    n_rgb, n_t = raster_ablate.raster_fwd16_ablate(*args, variant="nostage")
    assert torch.equal(n_rgb, rgb) and torch.equal(n_t, t_fin)
    px, py = j_v3.parent_grid(h, w)
    out = j_v3.forward_pallas_v3(jb, px * py, px)
    deflt = jnp.concatenate([jnp.zeros((px * py, 3, 8, 128)),
                             jnp.ones((px * py, 1, 8, 128))], axis=1)
    out = jnp.where(jb["parent_nonempty"][:, None, None, None], out, deflt)
    np.testing.assert_allclose(rgb.numpy()[:, :h, :w],
                               untile16(out[:, 0:3], px, py, 3)[:, :h, :w],
                               atol=ATOL)
    np.testing.assert_allclose(t_fin.numpy()[:h, :w],
                               untile16(out[:, 3:4], px, py, 1)[0][:h, :w],
                               atol=ATOL)


def test_ablation_noaccum_keeps_the_chain():
    _, tb, _, tiles_x, tiles_y, h, w = both_binnings("n512_96x128", 32)
    args = (tb.records, tb.tile_start, tb.tile_end, tiles_x, tiles_y, h, w)
    rgb, t_fin = raster_ablate.raster_fwd16_ablate(*args, variant="noaccum")
    full = raster_ablate.raster_fwd16_ablate(*args, variant="full")
    assert not rgb.any() and torch.equal(t_fin, full[1])
    assert full[0].any()


def noscan_numpy(records, tile_start, tile_end, tiles_x, tiles_y, h, w):
    """`noscan` as a float32 loop over each tile's records, all of the
    tile's pixels at once."""
    rgb = np.zeros((3, 16 * tiles_y, 16 * tiles_x), np.float32)
    f32 = np.float32
    for t in range(tiles_x * tiles_y):
        ys, xs = np.mgrid[0:16, 0:16]
        x = (t % tiles_x) * 16 + xs
        y = (t // tiles_x) * 16 + ys
        live = (x < w) & (y < h)
        px, py = x.astype(f32), y.astype(f32)
        acc = np.zeros((3, 16, 16), f32)
        for i in range(tile_start[t], tile_end[t]):
            mx, my, ca, cb, cc, op, r, g, b = records[:, i]
            dx, dy = mx - px, my - py
            power = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = np.minimum(f32(0.99), op * np.exp(power))
            ok = live & (power <= 0) & (alpha >= f32(1 / 255))
            wgt = np.where(ok, alpha, f32(0))
            acc += np.stack([r * wgt, g * wgt, b * wgt])
            live &= ~(ok & (alpha > f32(0.97)))
        rgb[:, y, x] = acc
    return rgb


@pytest.mark.parametrize("scene", ["n512_96x128", "ties"])
def test_ablation_noscan_matches_numpy(scene):
    _, tb, _, tiles_x, tiles_y, h, w = both_binnings(scene, 32)
    args = (tb.records, tb.tile_start, tb.tile_end, tiles_x, tiles_y, h, w)
    rgb, t_fin = raster_ablate.raster_fwd16_ablate(*args, variant="noscan")
    want = noscan_numpy(tb.records.numpy(), tb.tile_start.numpy(),
                        tb.tile_end.numpy(), tiles_x, tiles_y, h, w)
    np.testing.assert_allclose(rgb.numpy(), want, rtol=0, atol=1e-5)
    assert bool((t_fin == 1.0).all())
    assert float((rgb - raster_ablate.raster_fwd16_ablate(
        *args, variant="full")[0]).abs().max()) > 0  # not the blend


def test_profile_tool_runs_on_cpu_at_a_small_size():
    """tools/profile_torch_kernel_v3.py's scene and variants at 3,000
    gaussians and 160x96: every variant launched (the plain versions
    here), `full` the port's forward."""
    res = pk.run(torch.device("cpu"), n=3000, width=160, height=96)
    binned = res["binned"]
    tiles_x, tiles_y = res["grid"]
    assert binned.records.shape[1] > 0
    assert sorted(res["out"]) == sorted(raster_ablate.VARIANTS)
    args = (binned.records, binned.tile_start, binned.tile_end, tiles_x,
            tiles_y, 96, 160)
    assert res["args"] == args  # what chip_smoke's checks rerun
    want = raster_fwd_plain(*args, tile=16)
    assert torch.equal(res["out"]["full"][0], want[0])
    assert torch.equal(res["out"]["full"][1], want[1])


@pytest.mark.parametrize("n_bytes, n_ops, by", [(3.35e9, 1e9, "bytes"),
                                                (1e6, 67e9, "operations")])
def test_bound_takes_the_larger_time(n_bytes, n_ops, by):
    """measure.bound: bytes at 3.35 TB/s against fp32 operations at 67
    Tflop/s, 1 ms for the side that bounds."""
    ms, what = measure.bound(n_bytes, n_ops)
    assert what == by and ms == pytest.approx(1.0)


@pytest.mark.parametrize("term, work", [
    ("bytes", (3.35e9, 1e9, 1e9)),
    ("operations", (1e6, 67e9, 1e9)),
    ("sfu", (1e6, 1e9, 132 * 16 * 1.98e6))])
def test_bound_takes_the_largest_of_three_terms(term, work):
    """measure.bound with the exps counted on the special-function unit
    (132 SMs x 16 a clock x 1.98 GHz): 1 ms for the term that bounds,
    the others below it; the SFU's term reads as operations."""
    n_bytes, n_ops, n_sfu = work
    terms = measure.bound_terms(n_bytes, n_ops, n_sfu=n_sfu)
    assert max(terms, key=terms.get) == term
    assert terms[term] == pytest.approx(1.0)
    assert sorted(terms.values())[1] < 0.5
    ms, what = measure.bound(n_bytes, n_ops, n_sfu=n_sfu)
    assert ms == pytest.approx(1.0)
    assert what == ("bytes" if term == "bytes" else "operations")
