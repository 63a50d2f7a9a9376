"""The comparisons that decide `correct`, each number against its limit.

Training: the first steps (`check_steps`) of the window's own call,
against the reference's replay of them from the same inputs.
  loss_gap     max over the steps of |loss - ref| / |ref|
  grad_gap     the first gradient, as the optimizer got it (its first
               moment after step 1 over (1 - beta1)): per leaf
               |norm - ref norm| / max(ref norm, the median leaf's), the
               worst leaf
  update_median_gap
               the parameters' change after those steps, the same
               measure per leaf, over the leaves whose reference gradient
               is above a thousandth of the median leaf's (the others
               move by round-off alone under Adam), and its median over
               them: the worst leaf swings from seed to seed (a small
               leaf, a TPA weight or a bias, where Adam's second step
               nearly cancels and magnifies rounding), the median does
               not
Rendering: the sampled frames' 8-bit images against the reference's.
  image_diff_share  the share of values that differ at all: computing in
                    a lower precision moves a little every gaussian and
                    so a level at many pixels; a sound float32 change
                    moves a value across a level's edge only where it
                    lies within rounding of it (and a rare alpha or
                    clip threshold locally)
  image_mean_abs    mean |image - ref| over all values, in units of 1
                    (printed by calibrate.py; not compared: a few
                    threshold flips in a sound run read as much as the
                    control)
A number that is not finite fails; only the numbers a traffic mix gives
a limit are compared."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

# leaves whose reference gradient norm is below this share of the median
# leaf's are left out of update_median_gap
GRAD_FLOOR = 1e-3


def leaf_gaps(got: Sequence[float], want: Sequence[float]) -> List[float]:
    """Per leaf |got - want| / max(want, median of want)."""
    if not want:
        return [0.0]
    med = sorted(want)[len(want) // 2]
    return [abs(g - w) / max(w, med, 1e-30) for g, w in zip(got, want)]


def train_numbers(losses: Sequence[float], ref_losses: Sequence[float],
                  grad_norms: Dict[str, float],
                  ref_grad_norms: Dict[str, float],
                  change_norms: Dict[str, float],
                  ref_change_norms: Dict[str, float]) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    keys = sorted(ref_grad_norms)
    grad = leaf_gaps([grad_norms[k] for k in keys],
                     [ref_grad_norms[k] for k in keys])
    gmed = sorted(ref_grad_norms.values())[len(keys) // 2]
    moved = [k for k in keys if ref_grad_norms[k] > GRAD_FLOOR * gmed]
    update = leaf_gaps([change_norms[k] for k in moved],
                       [ref_change_norms[k] for k in moved])
    return {"loss_gap": loss_gap, "grad_gap": max(grad),
            "update_median_gap": statistics.median(update),
            # printed by calibrate.py: the worst leaves and their gaps
            "grad_gap_leaf": keys[grad.index(max(grad))],
            "update_worst_gap": max(update),
            "update_worst_leaf": moved[update.index(max(update))]
            if moved else ""}


def image_numbers(got: List[torch.Tensor], want: List[torch.Tensor]
                  ) -> Dict[str, float]:
    """got, want: [H, W, 3] uint8 images."""
    total = diff = values = 0
    for a, b in zip(got, want):
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        total += int(d.sum())
        diff += int((d > 0).sum())
        values += d.numel()
    return {"image_diff_share": diff / max(values, 1),
            "image_mean_abs": total / 255.0 / max(values, 1)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number finite and at most its limit, [(name, number,
    limit)])."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
