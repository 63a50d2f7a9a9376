"""The (view, gauss) mesh over torch.distributed ranks (counterpart of
splatco_tpu/parallel/mesh.py).

  view  - SVC data parallelism: each view row of the mesh renders one of
          the mv views of a step; the reference's one aggregated backward
          becomes a sum of gradients over the ranks.
  gauss - scene parallelism: the anchors are sharded over the gauss axis;
          each rank decodes its shard (BatchNorm statistics summed over
          the axis), the decoded gaussians are gathered, and each rank
          rasterizes a horizontal strip of its view.

Rank r sits at view r // n_gauss, gauss r % n_gauss.  The tri-plane and
decoder parameters are replicated on every rank; the anchor groups, their
Adam moments and the densification statistics are sliced by the gauss
index (`shard_params`), contiguous blocks of rows in gauss order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from splatco_torch.parallel.collectives import Group, gather_parts, make_group
from splatco_torch.train.optimizer import tree_map
from splatco_torch.train.step import TrainStats

STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_view, n_gauss) mesh and its groups:
    `gauss_group` the ranks of its view row (collectives "over gauss"),
    `view_group` those of its gauss column ("over view"), `world` all."""
    n_view: int
    n_gauss: int
    view: int
    gauss: int
    gauss_group: Group
    view_group: Group
    world: Group


def make_mesh(n_view: int, n_gauss: int) -> Mesh:
    """The mesh over the initialised process group, whose world size must
    be n_view * n_gauss.  Every rank makes every row's and every column's
    group, in the same order (rows, then columns), as new_group needs."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised "
                           "(parallel/distributed.init_distributed)")
    world = dist.get_world_size()
    if n_view * n_gauss != world:
        raise ValueError(f"mesh {n_view}x{n_gauss} needs "
                         f"{n_view * n_gauss} ranks, the world has {world}")
    rank = dist.get_rank()
    view, gauss = divmod(rank, n_gauss)
    rows = [list(range(v * n_gauss, (v + 1) * n_gauss))
            for v in range(n_view)]
    cols = [list(range(g, world, n_gauss)) for g in range(n_gauss)]
    row_pgs = [dist.new_group(r) for r in rows]
    col_pgs = [dist.new_group(c) for c in cols]
    return Mesh(n_view=n_view, n_gauss=n_gauss, view=view, gauss=gauss,
                gauss_group=make_group("gauss", rows[view], row_pgs[view]),
                view_group=make_group("view", cols[gauss], col_pgs[gauss]),
                world=make_group("world", range(world), dist.group.WORLD))


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x's rows (x's row count divides by n_gauss)."""
    n = x.shape[0]
    if n % mesh.n_gauss:
        raise ValueError(f"{n} rows do not divide over {mesh.n_gauss} "
                         "gauss ranks")
    step = n // mesh.n_gauss
    return x[mesh.gauss * step:(mesh.gauss + 1) * step]


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The full rows of a gauss-sharded x (no gradient)."""
    return torch.cat(gather_parts(x.detach(), mesh.gauss_group), dim=0)


def _map_anchors(fn, params: Dict[str, Any]) -> Dict[str, Any]:
    return dict(params, anchors=tree_map(fn, params["anchors"]))


def shard_params(mesh: Mesh, params, opt_state, active, stats: TrainStats):
    """(params, opt_state, active, stats) with the anchor groups, their
    Adam moments, the active mask and the statistics sliced to this rank's
    gauss block; everything else is left replicated."""
    cut = lambda x: shard_rows(mesh, x)  # noqa: E731
    return (_map_anchors(cut, params),
            dict(opt_state, **{m: _map_anchors(cut, opt_state[m])
                               for m in ("mu", "nu")}),
            cut(active),
            TrainStats(**{f: cut(getattr(stats, f)) for f in STAT_FIELDS}))


def unshard_params(mesh: Mesh, params, opt_state, active,
                   stats: TrainStats):
    """The inverse of `shard_params`: the full state on every rank of the
    view row (a gather over gauss)."""
    full = lambda x: gather_rows(mesh, x)  # noqa: E731
    act = gather_rows(mesh, active.to(torch.uint8)).to(torch.bool)
    return (_map_anchors(full, params),
            dict(opt_state, **{m: _map_anchors(full, opt_state[m])
                               for m in ("mu", "nu")}),
            act,
            TrainStats(**{f: full(getattr(stats, f)) for f in STAT_FIELDS}))
