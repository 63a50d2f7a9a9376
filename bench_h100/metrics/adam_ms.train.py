"""The step's "adam" phase (the multi-group Adam) in ms a step, by CUDA
events around the phase, its mean over the traced window's steps."""


def read(w):
    ms = w.stages.get("adam") if w.kind == "train" else None
    return sum(ms) / len(ms) if ms else None
