"""The program's profiler spans on the CPU, at the toy size of
tests/test_torch_train_step.py through the kernels' plain versions: one
frame opens `render` and `decode` once, one SVC step of mv views opens
`train_step` once, `render` mv times, `decode` mv + 1 times (each view's
and the shared tri-plane features') and `optimizer` once; each span lies
inside the one it belongs to; and the step gives the same bits with the
profiler on and off."""
import pytest
import torch
from test_torch_losses_optim import flat_torch
from test_torch_train_step import STAT_FIELDS, port_inputs, toy_case

from splatco_torch.config import ModelConfig
from splatco_torch.models.renderer import render
from splatco_torch.models.splatco import decode_kwargs
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.train.optimizer import make_optimizer as j_make_optimizer
from splatco_tpu.train.step import init_stats as j_init_stats

MV = 2  # the toy step's views
SPANS = ("train_step", "render", "decode", "optimizer")


@pytest.fixture(scope="module")
def toy():
    """(the port's ModelConfig, its step, the step's arguments)."""
    case = toy_case()
    jcfg, params = case[0], case[1]
    tx = j_make_optimizer(JOptimizationConfig(), params, 1.0, 0)
    stats = j_init_stats(params["anchors"]["anchor"].shape[0],
                         jcfg.n_offsets)
    step, args = port_inputs(case, params, tx.init(params), stats)
    cfg = ModelConfig(**{k: getattr(jcfg, k)
                         for k in ModelConfig.__dataclass_fields__})
    return cfg, step, args


def profiled(fn):
    """(fn's result, the host events [(name, start ns, end ns)] of a
    torch.profiler run around it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()]


@pytest.fixture(scope="module")
def traced(toy):
    cfg, step, args = toy
    params, active, contractor, cams, bg = (args[0], args[2], args[3],
                                            args[5], args[7])
    _, frame = profiled(lambda: render(params, active, contractor, cams[0],
                                       bg, activate_level=0,
                                       **decode_kwargs(cfg)))
    out, step_events = profiled(lambda: step(*args))
    return {"frame": frame, "step": step_events, "step_out": out}


def named(events, name):
    return [(s, e) for n, s, e in events if n == name]


@pytest.mark.parametrize("unit, want", [
    ("frame", {"train_step": 0, "render": 1, "decode": 1, "optimizer": 0}),
    ("step", {"train_step": 1, "render": MV, "decode": MV + 1,
              "optimizer": 1}),
])
def test_span_counts(traced, unit, want):
    assert {n: len(named(traced[unit], n)) for n in SPANS} == want


@pytest.mark.parametrize("unit, inner, outer", [
    ("frame", "decode", "render"),
    ("frame", "plane_sample", "decode"),
    ("frame", "projection", "render"),
    ("frame", "binning", "render"),
    ("step", "render", "train_step"),
    ("step", "decode", "train_step"),
    ("step", "optimizer", "train_step"),
])
def test_span_lies_inside(traced, unit, inner, outer):
    inside, around = named(traced[unit], inner), named(traced[unit], outer)
    assert inside and around
    assert all(any(a <= s and e <= b for a, b in around)
               for s, e in inside)


def test_step_bits_with_profiler_on_and_off(toy, traced):
    _, step, args = toy
    on, off = traced["step_out"], step(*args)
    for got, want in ((on[0], off[0]), (on[1]["mu"], off[1]["mu"]),
                      (on[1]["nu"], off[1]["nu"])):
        a, b = flat_torch(got), flat_torch(want)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(getattr(on[2], f), getattr(off[2], f))
               for f in STAT_FIELDS)
    assert all(torch.equal(on[3][k], off[3][k]) for k in ("loss", "l1",
                                                         "con"))
