"""The training cells' step time: the measured window's wall time, which
ends in a synchronize, over the steps completed in it, in ms."""


def read(w):
    if w.kind != "train" or w.ops or not w.units:
        return None
    return 1e3 * w.window_s / w.units
