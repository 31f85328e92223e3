"""Structure-of-arrays 3-vector, over torch tensors or the compiler's Syms.

Counterpart of ``sdfkit_tpu/utils/v3.py``. Each component is its own value
of any shape -- a tensor, a Python number, or a :class:`~sdfkit_tpu_torch.ops.Sym`
while the scene compiler traces -- and every op goes through
:mod:`sdfkit_tpu_torch.ops`, so the same SDF code runs on tensors and under
the compiler.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sdfkit_tpu_torch import ops

Value = Any


@dataclasses.dataclass(frozen=True)
class V3:
    """A 3-vector whose components are values of identical shape."""

    x: Value
    y: Value
    z: Value

    # -- constructors -----------------------------------------------------
    @staticmethod
    def splat(vec) -> "V3":
        """From a length-3 parameter, tensor or sequence (a constant vector)."""
        return V3(vec[0], vec[1], vec[2])

    @staticmethod
    def from_array(p: torch.Tensor) -> "V3":
        """From an (..., 3) tensor."""
        return V3(p[..., 0], p[..., 1], p[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z), dim=-1)

    # -- arithmetic -------------------------------------------------------
    @staticmethod
    def _coerce(o) -> "V3":
        return o if isinstance(o, V3) else V3(o, o, o)

    def __add__(self, o):
        o = self._coerce(o)
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return V3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return V3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- vector ops -------------------------------------------------------
    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def length(self):
        return ops.sqrt(self.length_sq())

    def zero_safe_length(self):
        """length() with a finite backward at the exact zero vector (the box
        SDF's exterior term is identically zero inside the box). The
        double-where keeps the forward value bit-identical."""
        ssq = self.length_sq()
        zero = ssq == 0
        return ops.where(zero, 0.0, ops.sqrt(ops.where(zero, 1.0, ssq)))

    def normalize(self) -> "V3":
        """Straight divide, no epsilon (reference Vector3.Normalize)."""
        return self / self.length()

    def safe_normalize(self, eps: float = 1e-30) -> "V3":
        """Normalize with the floor *inside* the sqrt, so the zero vector
        maps to zero with a NaN-free backward (tensors only: the kernel has
        its own copy in ``csrc/raymarch_fwd.cuh``)."""
        inv = torch.rsqrt(torch.clamp_min(self.length_sq(), eps))
        return self * inv

    def abs(self) -> "V3":
        return V3(ops.abs(self.x), ops.abs(self.y), ops.abs(self.z))

    def min(self, o) -> "V3":
        o = self._coerce(o)
        return V3(
            ops.minimum(self.x, o.x), ops.minimum(self.y, o.y), ops.minimum(self.z, o.z)
        )

    def max(self, o) -> "V3":
        o = self._coerce(o)
        return V3(
            ops.maximum(self.x, o.x), ops.maximum(self.y, o.y), ops.maximum(self.z, o.z)
        )

    def vmax(self):
        return ops.maximum(self.x, ops.maximum(self.y, self.z))

    def vmin(self):
        return ops.minimum(self.x, ops.minimum(self.y, self.z))

    def where(self, mask, other: "V3") -> "V3":
        """Select self where mask else other."""
        o = self._coerce(other)
        return V3(
            ops.where(mask, self.x, o.x),
            ops.where(mask, self.y, o.y),
            ops.where(mask, self.z, o.z),
        )


def vmod(a, b):
    """Floor-mod ``a - b*floor(a/b)`` (reference VectorOps.Mod). Not C's
    ``fmodf``, which truncates toward zero and breaks every negative cell."""
    return a - b * ops.floor(a / b)
