"""The comparisons that decide ``correct``: the program's outputs against
the benchmark's plain reference (``reference/``), each number against the
limit that ``limits/<cell>.json`` gives it. PERF.md gives the readings
each limit was set from.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails

    def line(self) -> dict:
        return {"value": self.value, "limit": self.limit}


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A frame against the reference's: the share of pixels whose largest
    channel gap passes 1e-2 and 5e-2, the median gap, and the count of
    values that are not finite."""
    got = got.float()
    d = (got - want).abs()
    px = d.amax(-1)
    return {"px_over_1e-2": float((px > 1e-2).float().mean()),
            "px_over_5e-2": float((px > 5e-2).float().mean()),
            "median_gap": float(d.median()),
            "nonfinite": float((~torch.isfinite(got)).sum())}


def worst(readings: list[dict]) -> dict:
    """Each number's worst over several readings."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_norm_gap(got: list, want: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger. Leaves whose reference norm is under a thousandth of the
    median leaf's are left out: their values move by round-off alone."""
    g = torch.stack([t.float().norm() for t in got])
    w = torch.stack([t.float().norm() for t in want])
    med = w.median()
    kept = w >= 1e-3 * med
    if not bool(kept.any()):
        return float("nan")
    gap = (g - w).abs() / torch.maximum(w, med)
    return float(gap[kept].max())


def loss_gaps(loss_pairs) -> list[float]:
    """Each (program, reference) pair of losses' gap, over the larger of the
    reference's loss and its first."""
    scale = abs(loss_pairs[0][1])
    return [abs(a - b) / max(abs(b), scale) for a, b in loss_pairs]


def fit_numbers(loss_pairs, grads, ref_grads, changes, ref_changes, window_losses) -> dict:
    """A fit against the reference's: each (program, reference) pair of
    losses (the worst gap, over the reference's loss there or its first
    loss, whichever is larger: a loss near its minimum makes a relative gap
    of nothing), the first gradient as the optimizer got it and the
    parameters' change over the steps followed (``leaf_norm_gap``), and the
    count of losses in the window that are not finite."""
    return {"loss_gap": max(loss_gaps(loss_pairs)),
            "grad_gap": leaf_norm_gap(grads, ref_grads),
            "change_gap": leaf_norm_gap(changes, ref_changes),
            "nonfinite": float(sum(not (x == x and abs(x) != float("inf"))
                                   for x in window_losses))}


def judge(numbers: dict, limits: dict) -> list[Check]:
    """Each number against its limit. A number the limits file does not
    name, or names with no number, is a fault of the file."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [Check(k, float(v), float(limits[k])) for k, v in numbers.items()]
