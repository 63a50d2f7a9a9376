"""The multi-process runtime over torch.distributed (counterpart of
splatco_tpu/parallel/distributed.py).

JAX runs one process per host; torch runs one process (rank) per card, or
several ranks sharing one card.  The JAX package's rule that the gauss
axis stays on one host becomes: every view row's ranks run on one host,
so the gauss axis's heavy collectives (the decoded gaussians, the strips)
never leave it and only the view axis's gradient sums cross hosts.

Backends: ranks that each own a card talk over NCCL; ranks that share a
card cannot (NCCL refuses two ranks on one device) and talk over gloo on
the CUDA tensors; ranks on the CPU use gloo.  There is no fallback from
one to another.

Run one process per rank, either with the JAX package's variables
    SPLATCO_COORDINATOR=host0:29500 SPLATCO_NUM_PROCESSES=N \\
    SPLATCO_PROCESS_ID=i [SPLATCO_BACKEND=gloo] python ...
or under torch's own launcher, which sets MASTER_ADDR, MASTER_PORT,
WORLD_SIZE and RANK:
    [SPLATCO_BACKEND=gloo] torchrun --standalone --nproc_per_node N ...

The JAX package's `local_view_rows`, `make_view_array` and
`place_host_sharded` have no counterpart: a rank feeds its own view
(`mesh.view`), and parallel/mesh.shard_params slices a value every rank
holds.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from splatco_torch.parallel.mesh import Mesh, make_mesh
from splatco_torch.utils.device import resolve_device

# a rank that dies fails the others' next collective after this long,
# instead of hanging them
TIMEOUT_S = 120
# the variables torchrun (torch.distributed.run) sets for each rank
TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group.  The arguments fall back to
    SPLATCO_COORDINATOR (host:port of rank 0), SPLATCO_NUM_PROCESSES,
    SPLATCO_PROCESS_ID and SPLATCO_BACKEND.  With neither a coordinator
    nor a process count given, torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK are used where all four are set (init_method
    "env://", which also joins torchrun's own store).  Returns False,
    and does nothing, when neither set of variables is there.

    `device` None means the card: rank i takes card i % device_count
    (torch.cuda.set_device, before the group is made), and the backend
    defaults to NCCL; on the CPU it is gloo.  Ranks sharing a card pass
    backend="gloo"."""
    coordinator = coordinator or os.environ.get("SPLATCO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SPLATCO_NUM_PROCESSES", "0")) \
            or None
    if process_id is None:
        pid = os.environ.get("SPLATCO_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    backend = backend or os.environ.get("SPLATCO_BACKEND") or None
    if coordinator is None and num_processes is None:
        if not all(v in os.environ for v in TORCHRUN_VARIABLES):
            return False
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the "
                         "process count and this process's id")
    else:
        init_method = f"tcp://{coordinator}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def check_rows_on_hosts(hosts: Sequence[str], n_view: int,
                        n_gauss: int) -> None:
    """Raise unless `hosts` (each rank's host, in rank order) fit an
    (n_view, n_gauss) mesh whose view rows each stay on one host."""
    if n_view * n_gauss != len(hosts):
        raise ValueError(f"mesh {n_view}x{n_gauss} != {len(hosts)} ranks")
    for host in sorted(set(hosts)):
        local = hosts.count(host)
        if local % n_gauss:
            raise ValueError(f"gauss axis {n_gauss} does not divide the "
                             f"{local} ranks of host {host}")
    for v in range(n_view):
        row = set(hosts[v * n_gauss:(v + 1) * n_gauss])
        if len(row) != 1:
            raise ValueError(f"view row {v} spans hosts {sorted(row)}: "
                             "the gauss axis must stay on one host")


def make_multihost_mesh(n_view: int, n_gauss: int) -> Mesh:
    """The (view, gauss) mesh over every rank, after checking that each
    view row's ranks share a host."""
    hosts: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    check_rows_on_hosts(hosts, n_view, n_gauss)
    return make_mesh(n_view, n_gauss)
