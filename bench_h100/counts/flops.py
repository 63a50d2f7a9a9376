"""fp32 operations a frame or an SVC step needs, from the configuration's
widths and the per-camera counts: a lower bound, so that a share of the
peak cannot pass 100 %.  Counted: the decode of the visible anchors (the
tri-plane samples, the fusion heads' BatchNorm and linear maps, the three
decoder MLPs), the prefilter and the projection, the blend, and in
training SSIM, the consistency term, the backward of each (twice the
linear maps' forward) and Adam.  Left out as small: the activations, the
binning's keys, L1, TV and the statistics."""
from __future__ import annotations

from typing import Dict

from bench_h100.counts import bounds as B

GEO = 64  # geo_fea: two 32-wide halves
HEAD_OUT = 32
# the EWA projection of a gaussian (forward, backward), the prefilter's
# radius-only projection of an anchor
PROJECT_OPS, PROJECT_BWD_OPS, PREFILTER_OPS = 300, 721, 100
# SSIM of a view: five blurred moment maps, two 11-tap passes of a
# multiply-add; the map (17), and backward the blur again and the map's
# VJP (38)
SSIM_TAPS = 11
SSIM_MAP_OPS, SSIM_MAP_BWD_OPS = 17, 38
ADAM_OPS = 12  # a parameter: the two moments, bias corrections, update


def _linear(i: int, o: int) -> int:
    return 2 * i * o


def decode_ops(model: Dict, level: int) -> int:
    """Per visible anchor."""
    f, k = model["feat_dim"], model["n_offsets"]
    r = model["num_channels"] // 3
    ctx = f + 3 + 3 * k + 6
    local = f + 3 + GEO
    ops = 0
    for lvl in range(level + 1):
        planes = 6 if lvl == 0 else 3
        ops += planes * 4 * r * 2  # bilinear: four corners a channel
        in_dim = 6 * r if lvl == 0 else 3 * r
        for dim in (in_dim, ctx):
            ops += 4 * dim + _linear(dim, HEAD_OUT)
    for out in (k, 7 * k, 3 * k):
        ops += _linear(local, f) + _linear(f, out)
    return ops


def linear_ops(model: Dict, level: int) -> int:
    """The part of decode_ops in linear maps (the backward does twice)."""
    f, k = model["feat_dim"], model["n_offsets"]
    r = model["num_channels"] // 3
    ctx = f + 3 + 3 * k + 6
    ops = 0
    for lvl in range(level + 1):
        ops += _linear(6 * r if lvl == 0 else 3 * r, HEAD_OUT)
        ops += _linear(ctx, HEAD_OUT)
    for out in (k, 7 * k, 3 * k):
        ops += _linear(f + 3 + GEO, f) + _linear(f, out)
    return ops


def frame_ops(model: Dict, anchors: int, level: int, w: Dict) -> float:
    """A rendered frame."""
    return (PREFILTER_OPS * anchors
            + decode_ops(model, level) * w["visible_anchors"]
            + PROJECT_OPS * w["gaussians"]
            + B.OPS_PER_PASS * w["passed"] + B.OPS_PER_CONTRIB * w["contribs"])


def ssim_ops(pixels: int) -> float:
    blur = 5 * 3 * pixels * 2 * SSIM_TAPS * 2
    return (2 * blur + 3 * 3 * pixels + (SSIM_MAP_OPS + SSIM_MAP_BWD_OPS)
            * 3 * pixels)


def step_ops(model: Dict, anchors: int, level: int, views, params: int
             ) -> float:
    """An SVC step over `views` (their per-camera counts)."""
    ops = ADAM_OPS * params
    for w in views:
        ops += frame_ops(model, anchors, level, w)
        ops += 2 * linear_ops(model, level) * w["visible_anchors"]
        ops += PROJECT_BWD_OPS * w["gaussians"]
        ops += (B.OPS_PER_PASS_BWD * w["passed"]
                + B.OPS_PER_CONTRIB_BWD * w["contribs"]
                + B.OPS_PER_RECORD_BWD * w["pairs"])
        ops += ssim_ops(w["image_pixels"])
    n = len(views)
    ops += n * (n - 1) // 2 * 4 * 3 * views[0]["image_pixels"]
    return ops
