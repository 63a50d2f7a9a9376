"""The step's "backward" phase (autograd: the blend's and the decode's
backward) in ms a step, by CUDA events around the phase, its mean over
the traced window's steps."""


def read(w):
    ms = w.stages.get("backward") if w.kind == "train" else None
    return sum(ms) / len(ms) if ms else None
