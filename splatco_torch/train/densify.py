"""Densification and pruning with fixed-capacity anchors (counterpart of
splatco_tpu/train/densify.py).

Every anchor tensor keeps its capacity C, and the active rows stay
contiguous in [0, A), as in the JAX package, so checkpoints, resume and
capacity regrowth see the same layout:

  * GROW (per depth level): candidate gaussians (gradient threshold and a
    stochastic keep) are voxel-quantized; one stable sort of
    (hash1, hash2, tag) against the existing anchors' voxel keys removes
    duplicates and rejects occupied cells at once (the first candidate of
    a cell wins; its feature is the elementwise max over the cell's
    candidates, `dedup_mode="max"`, or its own, `"first"`); a second sort
    compacts the winners, which are written at the active-count boundary.
    Overflow drops the newest rows and counts them in `num_dropped`.
  * PRUNE: a mask flip plus the base log-scale clamp (cols 3:5 <= 0.05).
  * COMPACT: one stable argsort of ~active and one gather of all row data
    (params, Adam moments, statistics) restores contiguity.

The two random draws are arguments, not generator calls: `keep_draws`
[update_depth, C*K] (the stochastic keep of each depth) and
`graph_downsample`'s `scores` [C], uniform in [0, 1).  The trainer draws
them from its torch.Generator; a test can feed the JAX package's own.
Every hash, sort and gather is integer-exact, so with the same draws the
integer results equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from splatco_torch.train.step import TrainStats
from splatco_torch.utils.math import inverse_sigmoid

HASH_A = (73856093, 19349663, 83492791)
HASH_B = (2654435761, 805459861, 3674653429)
SENTINEL = 0x7FFFFFFF
ROW_FIELDS = ("anchor", "feat", "offsets", "scaling", "rotation", "opacity")


class DensifyResult(NamedTuple):
    params: Dict[str, Any]
    opt_state: Any
    active: torch.Tensor
    stats: TrainStats
    num_active: torch.Tensor
    num_grown: torch.Tensor
    num_pruned: torch.Tensor
    num_dropped: torch.Tensor  # grown candidates dropped for lack of room


def _hash_coords(coords: torch.Tensor, consts) -> torch.Tensor:
    """XOR of coords[..., d] * consts[d] (constants masked to 31 bits),
    with int32 wrap-around: the products are taken in int64 and wrapped
    explicitly, so both devices give the same bits."""
    h = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                    device=coords.device)
    for d, c in enumerate(consts):
        h = h ^ ((coords[..., d].to(torch.int64) * (c & 0x7FFFFFFF))
                 & 0xFFFFFFFF)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _flatten_rows(params, mu, nu, stats: TrainStats, active, k: int
                  ) -> torch.Tensor:
    """All per-anchor row data as one [C, D] float32 matrix, for the
    compaction gather."""
    c = params["anchors"]["anchor"].shape[0]
    cols = []
    for name in ROW_FIELDS:
        for tree in (params["anchors"], mu, nu):
            cols.append(tree[name].reshape(c, -1).to(torch.float32))
    cols += [stats.opacity_accum, stats.anchor_demon,
             stats.offset_gradient_accum.reshape(c, k),
             stats.offset_denom.reshape(c, k),
             active[:, None].to(torch.float32)]
    return torch.cat(cols, dim=1)


def _unflatten_rows(mat: torch.Tensor, params, mu, nu, k: int):
    c = mat.shape[0]
    pos = 0

    def take(like: torch.Tensor) -> torch.Tensor:
        nonlocal pos
        d = like[0].numel()
        out = mat[:, pos:pos + d].reshape(like.shape).to(like.dtype)
        pos += d
        return out

    anchors, new_mu, new_nu = {}, dict(mu), dict(nu)
    for name in ROW_FIELDS:
        anchors[name] = take(params["anchors"][name])
        new_mu[name] = take(mu[name])
        new_nu[name] = take(nu[name])
    oa = mat[:, pos:pos + 1]
    ad = mat[:, pos + 1:pos + 2]
    oga = mat[:, pos + 2:pos + 2 + k].reshape(c * k, 1)
    od = mat[:, pos + 2 + k:pos + 2 + 2 * k].reshape(c * k, 1)
    active = mat[:, pos + 2 + 2 * k] > 0.5
    stats = TrainStats(opacity_accum=oa.contiguous(),
                       anchor_demon=ad.contiguous(),
                       offset_gradient_accum=oga.contiguous(),
                       offset_denom=od.contiguous())
    return dict(params, anchors=anchors), new_mu, new_nu, stats, active


def _compact(params, mu, nu, stats, keep: torch.Tensor, k: int):
    """Rows with `keep` first, each group in its old order."""
    mat = _flatten_rows(params, mu, nu, stats, keep, k)
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    return _unflatten_rows(mat[order], params, mu, nu, k)


def _segment_run_max(values: torch.Tensor, first_of_run: torch.Tensor
                     ) -> torch.Tensor:
    """Per-run elementwise max of `values` [S, D] over the contiguous runs
    that `first_of_run` [S] starts, written to every row of its run.  A
    max does not depend on the order of its operands, so the scatter is
    deterministic."""
    seg = torch.cumsum(first_of_run.to(torch.int64), 0) - 1
    idx = seg[:, None].expand_as(values)
    out = torch.full_like(values, -torch.inf).scatter_reduce(
        0, idx, values, "amax", include_self=True)
    return out[seg]


def _extend_insert(arr: torch.Tensor, block: torch.Tensor,
                   start: torch.Tensor) -> torch.Tensor:
    """`arr` with `block`'s rows written from row `start` on (a device
    scalar, at most len(arr)); rows past the end are dropped."""
    b = block.shape[0]
    ext = torch.cat([arr, arr.new_zeros((b,) + tuple(arr.shape[1:]))])
    rows = start + torch.arange(b, device=arr.device)
    ext[rows] = block.to(arr.dtype)
    return ext[:arr.shape[0]]


def _sort_rows(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by `keys` (most significant first),
    stable: chained stable sorts from the least significant key up."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def adjust_anchor(
    params: Dict[str, Any],
    opt_state: Dict[str, Any],
    active: torch.Tensor,
    stats: TrainStats,
    keep_draws: torch.Tensor,         # [update_depth, C*K] uniform [0, 1)
    voxel_size: float,
    grad_threshold: float,
    extra_offset_mask: torch.Tensor,  # [C*K] curvature contribution
    cvpm_prune: torch.Tensor,         # [C] CVPM mask
    *,
    check_interval: int = 100,
    success_threshold: float = 0.8,
    min_opacity: float = 0.005,
    update_depth: int = 3,
    update_init_factor: int = 16,
    update_hierachy_factor: int = 4,
    grow_cap: int = 0,
    dedup_mode: str = "max",
) -> DensifyResult:
    """One densify call: grow, prune, compact.  The inputs are not
    modified; the anchors' Adam moments are the opt_state's
    mu/nu["anchors"] rows and move with their anchors."""
    anchors = params["anchors"]
    dev = anchors["anchor"].device
    c = anchors["anchor"].shape[0]
    k = anchors["offsets"].shape[1]
    ck = c * k
    if grow_cap <= 0:
        grow_cap = max(c // 4, 256)
    f32 = torch.float32
    mu = dict(opt_state["mu"]["anchors"])
    nu = dict(opt_state["nu"]["anchors"])
    vs = torch.tensor(voxel_size, dtype=f32, device=dev)
    thr = torch.tensor(grad_threshold, dtype=f32, device=dev)

    grads = stats.offset_gradient_accum / torch.clamp_min(
        stats.offset_denom, 1e-12)
    grads = torch.where(stats.offset_denom > 0, grads, 0.0)
    grads_norm = grads[:, 0].abs()
    offset_mask = (stats.offset_denom[:, 0]
                   > check_interval * success_threshold * 0.5)
    offset_mask = ((offset_mask | extra_offset_mask)
                   & active.repeat_interleave(k))

    num_grown = torch.zeros((), dtype=torch.int64, device=dev)
    num_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    a_count = active.sum()
    sent = torch.tensor(SENTINEL, dtype=torch.int32, device=dev)
    rows = torch.arange(grow_cap, device=dev)

    for depth in range(update_depth):
        cur_thr = thr * ((update_hierachy_factor // 2) ** depth)
        cand = ((grads_norm >= cur_thr) & offset_mask
                & (keep_draws[depth] > 0.5 ** (depth + 1)))
        cur_size = vs * (update_init_factor
                         // (update_hierachy_factor ** depth))

        anchor = anchors["anchor"]
        scal = torch.exp(anchors["scaling"])[:, :3]
        all_xyz = (anchor[:, None, :] + anchors["offsets"] * scal[:, None, :]
                   ).reshape(ck, 3)
        cand_coords = torch.round(all_xyz / cur_size).to(torch.int32)
        exist_coords = torch.round(anchor / cur_size).to(torch.int32)

        def keys(consts):
            return torch.cat([
                torch.where(active, _hash_coords(exist_coords, consts), sent),
                torch.where(cand, _hash_coords(cand_coords, consts), sent)])

        h1, h2 = keys(HASH_A), keys(HASH_B)
        feat = anchors["feat"]
        pay = torch.cat([
            torch.cat([torch.zeros((c, 3), dtype=f32, device=dev),
                       cand_coords.to(f32) * cur_size]),
            torch.cat([torch.zeros_like(feat),
                       feat.repeat_interleave(k, dim=0)])], dim=1)
        # existing anchors (tag 0) are rows [0, C), candidates (tag 1) come
        # after, so the row order of the stable sort already ranks the tag
        # below (h1, h2)
        order = _sort_rows(h1, h2)
        sh1, sh2 = h1[order], h2[order]
        spay = pay[order]
        first_of_run = torch.cat([
            torch.ones(1, dtype=torch.bool, device=dev),
            (sh1[1:] != sh1[:-1]) | (sh2[1:] != sh2[:-1])])
        is_new = first_of_run & (order >= c) & (sh1 != sent)
        n_new = is_new.sum()
        if dedup_mode == "max":
            # a run that starts with an existing anchor is rejected, so an
            # accepted run holds only candidates: its max is the
            # reference's per-cell scatter_max
            spay = torch.cat([spay[:, :3],
                              _segment_run_max(spay[:, 3:], first_of_run)],
                             dim=1)

        # compact the winners to the front
        cidx = torch.argsort((~is_new).to(torch.int32), stable=True)
        comp = spay[cidx[:grow_cap]]
        take = torch.minimum(torch.clamp_max(n_new, grow_cap), c - a_count)
        valid_new = rows < take

        blocks = {
            "anchor": comp[:, :3],
            "feat": comp[:, 3:],
            "offsets": torch.zeros((grow_cap, k, 3), dtype=f32, device=dev),
            "scaling": torch.log(cur_size).expand(grow_cap, 6),
            "rotation": torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                     device=dev).expand(grow_cap, 4),
            "opacity": inverse_sigmoid(torch.tensor(
                0.1, dtype=f32, device=dev)).expand(grow_cap, 1),
        }
        new_anchors = {}
        for name, blk in blocks.items():
            m = valid_new.reshape((grow_cap,) + (1,) * (blk.dim() - 1))
            new_anchors[name] = _extend_insert(anchors[name], blk * m,
                                               a_count)
            mu[name] = _extend_insert(mu[name], torch.zeros_like(blk),
                                      a_count)
            nu[name] = _extend_insert(nu[name], torch.zeros_like(blk),
                                      a_count)
        anchors = new_anchors
        active = _extend_insert(active, valid_new, a_count)
        zc = torch.zeros((grow_cap, 1), device=dev)
        zk = torch.zeros((grow_cap, k), device=dev)
        stats = TrainStats(
            opacity_accum=_extend_insert(stats.opacity_accum, zc, a_count),
            anchor_demon=_extend_insert(stats.anchor_demon, zc, a_count),
            offset_gradient_accum=_extend_insert(
                stats.offset_gradient_accum.reshape(c, k), zk,
                a_count).reshape(ck, 1),
            offset_denom=_extend_insert(
                stats.offset_denom.reshape(c, k), zk,
                a_count).reshape(ck, 1))
        a_count = a_count + take
        num_grown = num_grown + take
        num_dropped = num_dropped + (n_new - take)

    # reset the statistics of the slots grown from
    om = offset_mask[:, None]
    stats = dataclasses.replace(
        stats,
        offset_denom=torch.where(om, 0.0, stats.offset_denom),
        offset_gradient_accum=torch.where(om, 0.0,
                                          stats.offset_gradient_accum))

    # prune: low opacity over a well-observed window, or CVPM
    demon = stats.anchor_demon[:, 0]
    well = demon > check_interval * success_threshold
    prune = (stats.opacity_accum[:, 0] < min_opacity * demon) & well
    prune = (prune | cvpm_prune) & active
    num_pruned = prune.sum()
    stats = dataclasses.replace(
        stats,
        opacity_accum=torch.where(well[:, None], 0.0, stats.opacity_accum),
        anchor_demon=torch.where(well[:, None], 0.0, stats.anchor_demon))
    active = active & ~prune
    sc = anchors["scaling"]
    anchors = dict(anchors, scaling=torch.cat(
        [sc[:, :3], torch.clamp_max(sc[:, 3:], 0.05)], dim=1))

    params, mu, nu, stats, active = _compact(
        dict(params, anchors=anchors), mu, nu, stats, active, k)
    opt_state = dict(opt_state,
                     mu=dict(opt_state["mu"], anchors=mu),
                     nu=dict(opt_state["nu"], anchors=nu))
    return DensifyResult(
        params=params, opt_state=opt_state, active=active, stats=stats,
        num_active=active.sum(), num_grown=num_grown,
        num_pruned=num_pruned, num_dropped=num_dropped)


def graph_downsample(params: Dict[str, Any], opt_state: Dict[str, Any],
                     active: torch.Tensor, stats: TrainStats,
                     scores: torch.Tensor, rate: float):
    """Random anchor subsampling: keep floor(rate * num_active) active
    anchors, those of the lowest `scores` ([C] uniform in [0, 1)), then
    compact.  -> (params, opt_state, active, stats, num_active)."""
    k = params["anchors"]["offsets"].shape[1]
    n_act = active.sum()
    keep_n = torch.floor(n_act.to(torch.float32) * torch.tensor(
        rate, dtype=torch.float32, device=active.device)).to(torch.int64)
    scores = torch.where(active, scores, 2.0)
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    keep = active & (rank < keep_n)
    params, mu, nu, stats, active = _compact(
        params, opt_state["mu"]["anchors"], opt_state["nu"]["anchors"],
        stats, keep, k)
    opt_state = dict(opt_state,
                     mu=dict(opt_state["mu"], anchors=mu),
                     nu=dict(opt_state["nu"], anchors=nu))
    return params, opt_state, active, stats, active.sum()
