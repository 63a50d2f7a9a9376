"""The largest scene a card trains: the device allocator's peak over the
measured training window (reset at its start), in GiB."""


def read(w):
    if w.kind != "train" or w.ops or not w.peak_bytes:
        return None
    return w.peak_bytes / 2 ** 30
