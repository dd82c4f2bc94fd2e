"""The numbers that decide ``correct``, each held to its cell's limit.

Training: each of the first three steps' loss against the reference's
(``loss_gap``, relative); by the worst leaf the gap between the program's
and the reference's norm of the first gradient (``grad_gap``); and at the
median leaf the gap of the weights' change after the three steps
(``change_median_gap``) and of the EMA's (``ema_median_gap``). A leaf's gap
is taken against the reference's norm of that leaf or of the median leaf,
whichever is larger. ``train_gaps`` also gives both changes by the worst
leaf (``change_gap``, ``ema_gap``), which ``benchmark/control.py`` prints
and no limit holds: they read the noise of small leaves, an element whose
gradient is near Adam's eps moving by a share of the learning rate that
the gradient's last bits decide, and the EMA of a leaf valued near 1
moving by a few fp32 ulps in three steps. The changes leave out leaves
whose reference gradient is under a thousandth of the median leaf's: under
Adam such a leaf moves by round-off alone.

Sampling: ``start_gap`` (the chain's first state against the start noise,
exact), ``step_gap`` (the chain's state after each step against the
reference's step from the state before it, the worst step) and
``decode_gap`` (the images against the reference's decode of the chain's
result), each the largest absolute difference over the largest reference
magnitude.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

__all__ = ["Check", "checks_from", "leaf_gaps", "moving_leaves", "rel_gap", "train_gaps"]


class Check:
    """One compared number and its limit; it holds when finite and within."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], names) -> List[float]:
    """Per leaf of ``names``: |‖got‖ - ‖ref‖| over the larger of the leaf's
    ‖ref‖ and the median leaf's."""
    med = statistics.median(ref[k] for k in names)
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]


def moving_leaves(ref: dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the median leaf's."""
    med = statistics.median(ref["grad"].values())
    return [k for k, g in ref["grad"].items() if g >= 1e-3 * med]


def train_gaps(got: dict, ref: dict) -> Dict[str, float]:
    """The training numbers of ``got``'s readings against ``ref``'s."""
    moving = moving_leaves(ref)
    change = leaf_gaps(got["change"], ref["change"], moving)
    ema = leaf_gaps(got["ema_change"], ref["ema_change"], moving)
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], ref["loss"])),
        "grad_gap": max(leaf_gaps(got["grad"], ref["grad"], list(ref["grad"]))),
        "change_gap": max(change), "change_median_gap": statistics.median(change),
        "ema_gap": max(ema), "ema_median_gap": statistics.median(ema),
    }


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (inf where got is not finite)."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    return [Check(k, values[k], limits[k]) for k in limits]
