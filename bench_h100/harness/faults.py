"""Faults planted in the timed path, underneath the harness, for the
tests that show the check rejects them and for calibrate.py's readings:

    unchanged    the training step returns the state it was given
    half_batch   the training step sees the first half of its views twice:
                 half of the batch left out, the mean taken over the rest
    altered      the rendered image altered where it is produced: the top
                 left eighth of it (in each direction) set to 0, in
                 training and in rendering

A one-chip cell has no exchange between chips to leave out."""
from __future__ import annotations

import contextlib

from bench_h100.harness import program as prog

FAULTS = ("unchanged", "half_batch", "altered")


def _unchanged(make):
    def make_step(*a, **kw):
        step = make(*a, **kw)

        def broken(params, opt_state, active, contractor, stats, *rest,
                   **kws):
            metrics = step(params, opt_state, active, contractor, stats,
                           *rest, **kws)[3]
            return params, opt_state, stats, metrics
        return broken
    return make_step


def _half_batch(make):
    def make_step(*a, **kw):
        step = make(*a, **kw)

        def broken(params, opt_state, active, contractor, stats, cams, gts,
                   *rest, **kws):
            h = len(cams) // 2
            return step(params, opt_state, active, contractor, stats,
                        list(cams[:h]) * 2, list(gts[:h]) * 2, *rest, **kws)
        return broken
    return make_step


def _altered(render):
    def broken(*a, **kw):
        out = render(*a, **kw)
        img = out.image.clone()
        h, w = img.shape[-2:]
        img[..., :max(h // 8, 1), :max(w // 8, 1)] = 0.0
        return out._replace(image=img)
    return broken


@contextlib.contextmanager
def planted(fault: str):
    """The program broken by `fault` (one of FAULTS) inside the block."""
    import splatco_torch.train.step as step_mod
    saved = [(prog, "make_train_step", prog.make_train_step),
             (prog, "render", prog.render),
             (step_mod, "render", step_mod.render)]
    try:
        if fault == "unchanged":
            prog.make_train_step = _unchanged(prog.make_train_step)
        elif fault == "half_batch":
            prog.make_train_step = _half_batch(prog.make_train_step)
        elif fault == "altered":
            prog.render = _altered(prog.render)
            step_mod.render = _altered(step_mod.render)
        else:
            raise ValueError(f"fault {fault!r} not in {FAULTS}")
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
