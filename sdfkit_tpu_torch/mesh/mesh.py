"""Triangle mesh container and OBJ export (reference: SdfKit/Mesh.cs).

The port's own copy of ``sdfkit_tpu/mesh/mesh.py``: numpy only.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Triangle soup: (V,3) vertices/colors/normals and flat (T*3,) indices
    (reference: Mesh.cs:10-13)."""

    vertices: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    triangles: np.ndarray

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.colors = np.asarray(self.colors, np.float32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, np.int32).reshape(-1)

    # -- bounds (reference: Mesh.Measure, Mesh.cs:30-45) ------------------
    @property
    def vmin(self) -> np.ndarray:
        if len(self.vertices) == 0:
            return np.zeros(3, np.float32)
        return self.vertices.min(axis=0)

    @property
    def vmax(self) -> np.ndarray:
        if len(self.vertices) == 0:
            return np.zeros(3, np.float32)
        return self.vertices.max(axis=0)

    @property
    def center(self) -> np.ndarray:
        return (self.vmin + self.vmax) * 0.5

    @property
    def size(self) -> np.ndarray:
        return self.vmax - self.vmin

    @property
    def radius(self) -> float:
        return float(np.linalg.norm(self.size) * 0.5)

    def transform(self, matrix: np.ndarray) -> "Mesh":
        """Transform vertices by the row-vector matrix and normals by its
        inverse-transpose (reference: Mesh.Transform, Mesh.cs:47-64)."""
        m = np.asarray(matrix, np.float32)
        nm = m.copy()
        nm[3, :] = [0, 0, 0, 1]
        nm = np.linalg.inv(nm).T.astype(np.float32)
        if len(self.vertices):
            v = self.vertices @ m[:3, :3] + m[3, :3]
            n = self.normals @ nm[:3, :3]
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            n = n / np.where(norm > 0, norm, 1.0)
        else:
            v, n = self.vertices, self.normals
        return Mesh(v, self.colors.copy(), n, self.triangles.copy())

    # -- OBJ export (reference: Mesh.WriteObj, Mesh.cs:66-97) -------------
    def write_obj(self, path_or_file) -> None:
        """ASCII OBJ: v/vn lines then 1-based ``f i//i`` faces."""
        if hasattr(path_or_file, "write"):
            self._write_obj(path_or_file)
        else:
            with open(path_or_file, "w") as f:
                self._write_obj(f)

    def _write_obj(self, w) -> None:
        for v in self.vertices:
            w.write(f"v {_fmt(v[0])} {_fmt(v[1])} {_fmt(v[2])}\n")
        for n in self.normals:
            w.write(f"vn {_fmt(n[0])} {_fmt(n[1])} {_fmt(n[2])}\n")
        t = self.triangles
        for i in range(0, len(t), 3):
            a, b, c = t[i] + 1, t[i + 1] + 1, t[i + 2] + 1
            w.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")

    def to_obj_string(self) -> str:
        buf = io.StringIO()
        self._write_obj(buf)
        return buf.getvalue()


def _fmt(x: float) -> str:
    """Invariant-culture float formatting like .NET's default ToString."""
    return np.format_float_positional(x, trim="-")
