"""Frozen peaks, bounds and operation counts: the yardstick of the
rooflines and the mfu metrics, from the configuration's widths and the
per-camera counts of harness/counting.py."""
