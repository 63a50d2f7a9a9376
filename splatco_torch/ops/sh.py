"""Degree-0 spherical harmonics <-> RGB (counterpart of the helpers at the
end of splatco_tpu/ops/sh.py).  Plain arithmetic: they take numpy arrays
or tensors alike.  `eval_sh` is not ported yet."""
from __future__ import annotations

C0 = 0.28209479177387814


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5
