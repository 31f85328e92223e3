"""The least time an H100 needs for a count of operations and bytes.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s. A card set
below 700 W runs slower under load, so every result carries the card's
``power.limit`` beside its shares.

Operations are counted by the rule of the scene compiler's node count at
the benchmark's first commit (one node of the compiled program is one
operation), frozen per scene in its configuration's ``counts``, plus the
fixed work around a distance evaluation named here. The metric readers
(``metrics/kernel.*_roofline.*.py``) say what a frame and a gradient
need of them.
"""

from __future__ import annotations

PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

STEP_OPS = 7  # a march step around the distance: ro + rd * depth, and the depth's add
SHADE_OPS = 60  # a pixel's ray, normalisations, Lambert and the sky select
TAPS = 6  # the finite-difference normal's distance evaluations
RAY_OPS = 30  # a camera ray: two NDC coordinates, four 3-term rows, three divides, a normalisation
# Around one unit gradient of a march step, besides the distance's adjoint:
# the point (6), grad d . rd (5), the gradient times the depth (3), the ray's
# six sums (12) and the recurrence (2).
UNIT_OPS = 28


def least_seconds(operations: float, nbytes: float) -> float:
    """The larger of operations over the float32 peak and bytes over the
    memory peak."""
    return max(operations / PEAK_FP32_OPS, nbytes / PEAK_BYTES)
