"""Multi-group Adam with the reference's per-group learning-rate schedules
(counterpart of splatco_tpu/train/optimizer.py).

One Adam (eps 1e-15) over ~14 parameter groups: anchor/offset/decoder-MLP
groups follow exponential log-lerp schedules (the spatial ones scaled by
the scene radius), the plane groups get a static LR that depends on which
pyramid level is active (0.01 active / 0.001 inactive; fusion heads 1e-4 /
1e-5), and the CTX fusion heads stay frozen at LR 0 unless
`train_ctx_heads` (a reference quirk).  Rebuild the optimizer when the
active level changes.

The update is plain functions over dicts of tensors, and repeats optax's
`multi_transform` of `chain(scale_by_adam(eps=1e-15),
scale_by_schedule(-lr))` in float32, op for op.  The state is
    {"count": {group: int32 []},        # Adam's count (bias correction)
     "sched_count": {group: int32 []},  # the schedule's count
     "mu": tree like params, "nu": tree like params}
Two counts per group, as in optax: a resumed run fast-forwards only the
schedule's.  Frozen groups (LR 0) still update their moments.  It is
written out instead of `torch.optim.Adam` because densify and resume do
row surgery on the moments.  `update` runs inside
`torch.profiler.record_function("optimizer")`.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, NamedTuple

import numpy as np
import torch

from splatco_torch.config import OptimizationConfig
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.utils.device import resolve_device
from splatco_torch.utils.math import expon_lr

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _sched(lr_init, lr_final, delay_mult, max_steps) -> Schedule:
    def fn(step):
        return expon_lr(step, lr_init, lr_final, lr_delay_steps=0,
                        lr_delay_mult=delay_mult, max_steps=max_steps)
    return fn


def _const(lr) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def group_schedules(opt: OptimizationConfig, spatial_lr_scale: float,
                    activate_level: int, num_levels: int = 3,
                    train_ctx_heads: bool = False) -> Dict[str, Schedule]:
    s = {
        "anchor": _sched(opt.position_lr_init * spatial_lr_scale,
                         opt.position_lr_final * spatial_lr_scale,
                         opt.position_lr_delay_mult,
                         opt.position_lr_max_steps),
        "offset": _sched(opt.offset_lr_init * spatial_lr_scale,
                         opt.offset_lr_final * spatial_lr_scale,
                         opt.offset_lr_delay_mult, opt.offset_lr_max_steps),
        "anchor_feat": _const(opt.feature_lr),
        "opacity": _const(opt.opacity_lr),
        "scaling": _const(opt.scaling_lr),
        "rotation": _const(opt.rotation_lr),
        "mlp_opacity": _sched(opt.mlp_opacity_lr_init,
                              opt.mlp_opacity_lr_final,
                              opt.mlp_opacity_lr_delay_mult,
                              opt.mlp_opacity_lr_max_steps),
        "mlp_cov": _sched(opt.mlp_cov_lr_init, opt.mlp_cov_lr_final,
                          opt.mlp_cov_lr_delay_mult,
                          opt.mlp_cov_lr_max_steps),
        "mlp_color": _sched(opt.mlp_color_lr_init, opt.mlp_color_lr_final,
                            opt.mlp_color_lr_delay_mult,
                            opt.mlp_color_lr_max_steps),
        "mlp_featurebank": _sched(opt.mlp_featurebank_lr_init,
                                  opt.mlp_featurebank_lr_final,
                                  opt.mlp_featurebank_lr_delay_mult,
                                  opt.mlp_featurebank_lr_max_steps),
        "embedding_appearance": _sched(opt.appearance_lr_init,
                                       opt.appearance_lr_final,
                                       opt.appearance_lr_delay_mult,
                                       opt.appearance_lr_max_steps),
        "frozen": _const(0.0),
    }
    for i in range(num_levels):
        act = i == activate_level
        s[f"planes{i}"] = _const(opt.plane_lr_active if act
                                 else opt.plane_lr_inactive)
        s[f"plane_head{i}"] = _const(opt.plane_mlp_lr_active if act
                                     else opt.plane_mlp_lr_inactive)
        s[f"ctx_head{i}"] = (s[f"plane_head{i}"] if train_ctx_heads
                             else _const(0.0))
    return s


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts/lists of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def label_params(params: Dict[str, Any], num_levels: int = 3
                 ) -> Dict[str, Any]:
    """The label tree mapping each leaf to its LR group."""
    def fill(tree, label):
        return tree_map(lambda _: label, tree)

    labels: Dict[str, Any] = {
        "anchors": {
            "anchor": "anchor", "offsets": "offset",
            "feat": "anchor_feat", "opacity": "opacity",
            "scaling": "scaling", "rotation": "rotation",
        },
        "decoders": {},
        "planes": {"grids": [], "heads": [], "ctx_heads": []},
    }
    for name in params["decoders"]:
        lbl = {"opacity": "mlp_opacity", "cov": "mlp_cov",
               "color": "mlp_color", "feature_bank": "mlp_featurebank",
               "appearance": "embedding_appearance"}[name]
        labels["decoders"][name] = fill(params["decoders"][name], lbl)
    for i in range(len(params["planes"]["grids"])):
        labels["planes"]["grids"].append(
            fill(params["planes"]["grids"][i], f"planes{i}"))
        labels["planes"]["heads"].append(
            fill(params["planes"]["heads"][i], f"plane_head{i}"))
        labels["planes"]["ctx_heads"].append(
            fill(params["planes"]["ctx_heads"][i], f"ctx_head{i}"))
    # TriPlaneAttention params belong to level 0's grid group (the
    # reference registers them with level 0's parameters)
    labels["planes"]["tpa"] = fill(params["planes"]["tpa"], "planes0")
    return labels


class Optimizer(NamedTuple):
    """`init(params) -> state` and `update(grads, state, params) ->
    (new_params, new_state)`, like an optax transformation that also
    applies its updates.  Inputs are not modified."""
    init: Callable
    update: Callable


def make_optimizer(opt: OptimizationConfig, params: Dict[str, Any],
                   spatial_lr_scale: float, activate_level: int,
                   train_ctx_heads: bool = False, device=None) -> Optimizer:
    """The multi-group Adam for `params`; its state lives on `device`
    (default the card)."""
    dev = resolve_device(device)
    num_levels = len(params["planes"]["grids"])
    scheds = group_schedules(opt, spatial_lr_scale, activate_level,
                             num_levels, train_ctx_heads)
    labels = label_params(params, num_levels)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, device=dev)  # noqa: E731
        count = {g: torch.zeros((), dtype=torch.int32, device=dev)
                 for g in scheds}
        return {"count": count,
                "sched_count": {g: c.clone() for g, c in count.items()},
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        with torch.profiler.record_function("optimizer"):
            count_inc = {g: c + 1 for g, c in state["count"].items()}
            # bias corrections and step sizes per group, in float32
            b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=dev)
            b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=dev)
            bc1 = {g: 1 - b1 ** c for g, c in count_inc.items()}
            bc2 = {g: 1 - b2 ** c for g, c in count_inc.items()}
            neg_lr = {g: -fn(state["sched_count"][g])
                      for g, fn in scheds.items()}

            def leaf(label, g, mu, nu, p):
                mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
                nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
                u = ((mu / bc1[label])
                     / (torch.sqrt(nu / bc2[label]) + ADAM_EPS))
                return p + neg_lr[label] * u, mu, nu

            out = tree_map(leaf, labels, grads, state["mu"], state["nu"],
                           params)
            new_params = tree_map(lambda o: o[0], out)
            new_state = {
                "count": count_inc,
                "sched_count": {g: c + 1
                                for g, c in state["sched_count"].items()},
                "mu": tree_map(lambda o: o[1], out),
                "nu": tree_map(lambda o: o[2], out),
            }
            return new_params, new_state

    return Optimizer(init=init, update=update)


_OPTAX_KEY = re.compile(
    r"^\.inner_states\['([^']+)'\]\.inner_state\[([01])\]\."
    r"(count|mu|nu)(.*)$")


def opt_state_from_numpy(flat: Mapping[str, np.ndarray], device=None
                         ) -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's optax state,
    flattened to arrays keyed by `jax.tree_util.keystr` paths, e.g.
    ".inner_states['anchor'].inner_state[0].mu['anchors']['anchor']".
    inner_state[0] is the group's Adam state (count, mu, nu), [1] its
    schedule's count; leaves masked out of a group do not appear."""
    dev = resolve_device(device)
    state: Dict[str, Any] = {"count": {}, "sched_count": {}}
    moments: Dict[str, Dict[str, np.ndarray]] = {"mu": {}, "nu": {}}
    for key, arr in flat.items():
        m = _OPTAX_KEY.match(key)
        if m is None:
            raise ValueError(f"not an optimizer state path: {key!r}")
        group, part, field, path = m.groups()
        if field == "count":
            slot = "count" if part == "0" else "sched_count"
            state[slot][group] = torch.as_tensor(
                np.array(arr, np.int32), device=dev)
        elif part == "0":
            moments[field][path] = arr
        else:
            raise ValueError(f"unexpected schedule state leaf: {key!r}")
    for field in ("mu", "nu"):
        state[field] = params_from_numpy(moments[field], device=dev)
    return state
