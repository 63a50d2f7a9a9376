"""A test set's or a fly-through's frame time: the measured window's wall
time over the frames whose 8-bit image reached host memory in it, in
ms."""


def read(w):
    if w.kind != "render" or w.ops or not w.units:
        return None
    return 1e3 * w.window_s / w.units
