"""One rank of tests/test_torch_parallel.py's process groups, on the CPU
over gloo.  Imports torch, numpy and splatco_torch only.

    python tests/_torch_parallel_worker.py <inputs.npz> <out_dir>
        [--explicit]

joins the group from the SPLATCO_* variables, or torchrun's (with
--explicit, from arguments made of the SPLATCO_* ones, the variables
removed first), and runs the cases
of its world size on the model in inputs.npz (the JAX package's initial
params, the views' ground truths and the model config):
  4 ranks (a 2x2 mesh): `step` one dense sharded step at q = 0 (the
      JAX comparison), repeated from the same state, and the replicated
      leaves' digests of every rank; `mixed` one step on a 65x96 / 64x96
      batch padded by pad_view_batch; `loop` the sharded training loop
      (densify, capacity regrowth, a level bump) beside the single-device
      trajectory, which rank 0 runs in lockstep,
  2 ranks (a 1x2 mesh): `cuda` and `dense`, the gradients of one
      sharded step through the kernel path (its plain versions here) and
      through the dense compositor; `cuda16` and `single16`, the sharded
      and the single-device step's gradients in the 16 px configuration
      of the SPLATCO_RASTER switch; `bn`, masked_batchnorm over the gauss
      group.
Each rank writes <out_dir>/rank<r>.npz (arrays) and rank<r>.json.
"""
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from splatco_torch.config import ModelConfig  # noqa: E402
from splatco_torch.data.cameras import look_at_camera  # noqa: E402
from splatco_torch.models.contraction import Contractor  # noqa: E402
from splatco_torch.models.mlp import masked_batchnorm  # noqa: E402
from splatco_torch.models.splatco import params_from_numpy  # noqa: E402
from splatco_torch.ops import rasterize  # noqa: E402
from splatco_torch.parallel.distributed import (  # noqa: E402
    init_distributed, make_multihost_mesh)
from splatco_torch.parallel.dryrun import (  # noqa: E402
    ShardedTrajectory, sharded_loop, single_gradients, step_gradients,
    untie_offsets)
from splatco_torch.parallel.mesh import STAT_FIELDS  # noqa: E402
from splatco_torch.parallel.train_step import pad_view_batch  # noqa: E402

CPU = torch.device("cpu")
TERMS = (1.0, 4e-7, 1.0)  # consistency_on, tv_w, stats_on


def flat(tree, prefix=""):
    """{keystr path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, val in items:
        out.update(flat(val, prefix + key))
    return out


def load_model(data):
    cfg = ModelConfig(**json.loads(str(data["cfg"])))
    params = params_from_numpy(
        {k[2:]: data[k] for k in data.files if k.startswith("p:")},
        device=CPU)
    contractor = Contractor(xyz_min=torch.as_tensor(data["cmin"]),
                            xyz_max=torch.as_tensor(data["cmax"]),
                            enabled=bool(data["cenabled"]))
    return cfg, params, torch.as_tensor(data["active"]), contractor


def cameras(n_view: int, h: int, w: int, z_step: float = 0.0):
    """The views of tests/test_parallel.py's `build`."""
    return [look_at_camera([np.sin(i), 0.3, -3.0 + z_step * i], [0, 0, 0],
                           [0, -1, 0], 1.0, 1.0 * h / w, w, h, uid=i,
                           device=CPU) for i in range(n_view)]


def trajectory(mesh, cfg, params, active, backend="dense"):
    return ShardedTrajectory(mesh, cfg, params, active, backend, CPU,
                             terms=TERMS)


def digest(tree) -> str:
    h = hashlib.sha256()
    for key, leaf in sorted(flat(tree).items()):
        h.update(key.encode())
        h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def replicated(params, opt_state):
    """The leaves every rank holds whole: all but the anchor groups."""
    return {"params": {k: v for k, v in params.items() if k != "anchors"},
            "mu": {k: v for k, v in opt_state["mu"].items()
                   if k != "anchors"},
            "nu": {k: v for k, v in opt_state["nu"].items()
                   if k != "anchors"}}


def all_digests(tree):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, digest(tree))
    return out


def save_full(arrays, prefix, traj):
    params, opt_state, active, stats = traj.full()
    for key, leaf in flat(params).items():
        arrays[f"{prefix}p:{key}"] = leaf.numpy()
    for f in STAT_FIELDS:
        arrays[f"{prefix}s:{f}"] = getattr(stats, f).numpy()


def step_case(mesh, data, arrays, res):
    """The JAX comparison step, its repeat and the ranks' digests."""
    cfg, params, active, contractor = load_model(data)
    gts = torch.as_tensor(data["gts"])
    h, w = gts.shape[-2:]
    cam = cameras(mesh.n_view, h, w)[mesh.view]
    traj = trajectory(mesh, cfg, params, active)
    start = (traj.params, traj.opt_state, traj.stats)
    outs = [traj.step(contractor, cam, gts[mesh.view], carry=start)
            for _ in range(2)]
    res["loss"] = float(outs[0][3]["loss"])
    res["l1"] = float(outs[0][3]["l1"])
    res["repeat_identical"] = len({
        digest({"p": p, "mu": o["mu"], "nu": o["nu"],
                "s": {f: getattr(st, f) for f in STAT_FIELDS}})
        for p, o, st, _ in outs}) == 1
    res["replicated_digests"] = all_digests(
        replicated(outs[0][0], outs[0][1]))
    save_full(arrays, "step.", traj)


def mixed_case(mesh, data, arrays, res):
    """One step on a mixed-resolution pair padded to one canvas."""
    cfg, params, active, contractor = load_model(data)
    dims = [(65, 96), (64, 96)]
    rng = np.random.default_rng(5)
    cams = [look_at_camera([np.sin(i), 0.3, -3.0], [0, 0, 0], [0, -1, 0],
                           1.0, 1.0 * h / w, w, h, uid=i, device=CPU)
            for i, (h, w) in enumerate(dims)]
    gts = [torch.as_tensor(rng.uniform(size=(3, h, w)).astype(np.float32))
           for h, w in dims]
    cams_p, gts_p, view_geom = pad_view_batch(cams, gts, mesh.n_gauss)
    traj = trajectory(mesh, cfg, params, active)
    before = flat(traj.full()[0])
    out = traj.step(contractor, cams_p[mesh.view], gts_p[mesh.view],
                    view_geom=view_geom)
    after = flat(traj.full()[0])
    res["mixed_loss"] = float(out[3]["loss"])
    res["mixed_l1"] = float(out[3]["l1"])
    res["mixed_moved"] = max(float((after[k] - before[k]).abs().max())
                             for k in after)
    res["mixed_demon"] = float(traj.full()[3].anchor_demon.sum())
    res["mixed_canvas"] = list(gts_p.shape)


def loop_case(mesh, data, arrays, res):
    """The sharded loop against the single-device trajectory."""
    cfg, params, active, contractor = load_model(data)
    gts = torch.as_tensor(data["gts"])
    h, w = gts.shape[-2:]
    loop = sharded_loop(mesh, cfg, params, active, contractor,
                        cameras(mesh.n_view, h, w, z_step=0.1), gts,
                        "dense", CPU)
    res.update({f"loop_{k}": v for k, v in loop.items()})


def backend_case(mesh, data, arrays, res):
    """The gradients of one sharded step from one state: through the
    kernel path (`cuda`) and the dense compositor (`dense`), and in the
    16 px configuration at kmax 32 through the kernel path (`cuda16`)
    beside the single-device step's (`single16`), with the offsets
    untied (parallel/dryrun.untie_offsets)."""
    cfg, params, active, contractor = load_model(data)
    gts = torch.as_tensor(data["gts"])
    h, w = gts.shape[-2:]
    cams = cameras(mesh.n_view, h, w)
    cfg16 = dataclasses.replace(cfg, kmax=32)
    untied = untie_offsets(params, 3)
    default = rasterize.TILE16_DEFAULT
    runs = {
        "cuda": lambda: step_gradients(
            mesh, cfg, params, active, contractor, cams[mesh.view],
            gts[mesh.view], "cuda", CPU, terms=TERMS),
        "dense": lambda: step_gradients(
            mesh, cfg, params, active, contractor, cams[mesh.view],
            gts[mesh.view], "dense", CPU, terms=TERMS),
        "cuda16": lambda: step_gradients(
            mesh, cfg16, untied, active, contractor, cams[mesh.view],
            gts[mesh.view], "cuda", CPU, terms=TERMS),
        "single16": lambda: single_gradients(
            cfg16, untied, active, contractor, cams, gts, "cuda", CPU,
            terms=TERMS)}
    for name, run in runs.items():
        rasterize.TILE16_DEFAULT = name.endswith("16")
        grads, stats, metrics = run()
        res[f"{name}_loss"] = float(metrics["loss"])
        res[f"{name}_l1"] = float(metrics["l1"])
        res[f"{name}_clipped"] = int(metrics["num_clipped"])
        for key, leaf in flat(grads).items():
            arrays[f"{name}.g:{key}"] = leaf.numpy()
        for f in STAT_FIELDS:
            arrays[f"{name}.s:{f}"] = getattr(stats, f).numpy()
    rasterize.TILE16_DEFAULT = default


def bn_case(mesh, data, arrays, res):
    """masked_batchnorm over this rank's rows of a seeded batch, its
    statistics summed over the gauss group, with the gradients of a
    seeded cotangent."""
    rng = np.random.default_rng(11)
    x_all = rng.normal(size=(2 * 37, 5)).astype(np.float32) * 2.0 + 0.5
    mask_all = rng.uniform(size=2 * 37) < 0.7
    cot_all = rng.normal(size=(2 * 37, 5)).astype(np.float32)
    rows = slice(37 * mesh.gauss, 37 * (mesh.gauss + 1))
    x = torch.as_tensor(x_all[rows]).requires_grad_()
    bn = {"scale": torch.linspace(0.5, 1.5, 5).requires_grad_(),
          "bias": torch.linspace(-0.2, 0.2, 5).requires_grad_()}
    y = masked_batchnorm(bn, x, torch.as_tensor(mask_all[rows]),
                         group=mesh.gauss_group)
    (y * torch.as_tensor(cot_all[rows])).sum().backward()
    arrays.update({"bn.y": y.detach().numpy(), "bn.dx": x.grad.numpy(),
                   "bn.dscale": bn["scale"].grad.numpy(),
                   "bn.dbias": bn["bias"].grad.numpy()})


def main() -> int:
    torch.set_num_threads(1)
    inputs, out_dir, explicit = sys.argv[1], sys.argv[2], sys.argv[3:]
    if explicit == ["--explicit"]:
        # the same group from arguments, with the variables taken away
        joined = init_distributed(
            os.environ.pop("SPLATCO_COORDINATOR"),
            int(os.environ.pop("SPLATCO_NUM_PROCESSES")),
            int(os.environ.pop("SPLATCO_PROCESS_ID")), device=CPU)
    else:
        joined = init_distributed(device=CPU)
    assert joined
    rank, world = dist.get_rank(), dist.get_world_size()
    data = np.load(inputs)
    arrays, res = {}, {"rank": rank, "world": world,
                       "backend": dist.get_backend()}
    if world == 4:
        mesh = make_multihost_mesh(2, 2)
        cases = (step_case, mixed_case, loop_case)
    else:
        mesh = make_multihost_mesh(1, world)
        cases = (backend_case, bn_case)
    res["mesh"] = [mesh.n_view, mesh.n_gauss, mesh.view, mesh.gauss,
                   list(mesh.gauss_group.ranks), list(mesh.view_group.ranks)]
    for case in cases:
        t0 = time.perf_counter()
        case(mesh, data, arrays, res)
        res[f"{case.__name__}_s"] = time.perf_counter() - t0
    res["modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "splatco_tpu"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
