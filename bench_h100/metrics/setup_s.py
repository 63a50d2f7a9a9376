"""Set-up: process start to the measured window's start (import, the CUDA
context, kernels built or loaded, inputs made from the seed, warm-up and
the checked first steps), in s."""


def read(w):
    if w.ops or w.setup_s <= 0:
        return None
    return w.setup_s
