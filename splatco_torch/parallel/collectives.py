"""Collectives of the sharded step over torch.distributed, with gradients
(the counterparts of `psum`, `pmean`, `pmax` and the tiled `all_gather`
inside the JAX package's `shard_map`).

Every collective is built on one primitive, `dist.all_gather`, which NCCL
and gloo both take on CUDA tensors (gloo copies them through pinned host
memory itself).  A sum over a group is a gather followed by a left fold
in rank order, so each rank of the group adds the same parts in the same
order and every rank, on every run, ends with the same bits, whatever
algorithm the backend picks.  No float atomics.

Gradients are the transposes JAX's `shard_map(check_vma=False)` gives:
  * all_reduce_sum: the cotangent is summed over the group (every rank's
    output fed every rank's loss),
  * all_gather (tiled, along a dim): the cotangent is summed over the
    group, then this rank keeps its own slice (a reduce-scatter, done as
    the sum then the slice).

`trace()` times each collective on the host clock, the device synchronized
before and after it, and reckons its bytes from the shapes; off, a
collective costs nothing extra.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group of the mesh: `name` ("view", "gauss" or "world"),
    its global `ranks` in order and this rank's `index` among them."""
    name: str
    ranks: tuple
    index: int
    pg: object

    @property
    def size(self) -> int:
        return len(self.ranks)


def make_group(name: str, ranks: Sequence[int], pg) -> Group:
    return Group(name=name, ranks=tuple(ranks),
                 index=list(ranks).index(dist.get_rank()), pg=pg)


# {(op, group name): [calls, seconds, payload bytes]} while tracing
_TRACE: Optional[Dict[tuple, list]] = None


@contextlib.contextmanager
def trace():
    """Record every collective run inside the block: yields a dict
    {(op, group): [calls, seconds on the host clock, payload bytes]},
    the payload being the bytes one rank puts in (its part)."""
    global _TRACE
    prev, _TRACE = _TRACE, {}
    try:
        yield _TRACE
    finally:
        _TRACE = prev


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def gather_parts(x: torch.Tensor, group: Group, op: str = "all_gather"
                 ) -> List[torch.Tensor]:
    """Every rank's `x` (same shape and dtype on each), in rank order."""
    x = x.contiguous()
    if _TRACE is not None:
        _sync(x)
        t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    if _TRACE is not None:
        _sync(x)
        rec = _TRACE.setdefault((op, group.name), [0, 0.0, 0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
        rec[2] += x.numel() * x.element_size()
    return parts


def fold_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ..., left to right."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return fold_sum(gather_parts(x, group, "all_reduce"))

    @staticmethod
    def backward(ctx, g):
        return fold_sum(gather_parts(g, ctx.group, "all_reduce^T")), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group, dim: int):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(gather_parts(x, group, "all_gather"), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = fold_sum(gather_parts(g, ctx.group, "all_gather^T"))
        return (total.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n),
                None, None)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of `x` over the group (psum), differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (a tiled
    all_gather), differentiable."""
    return _AllGather.apply(x, group, dim)

