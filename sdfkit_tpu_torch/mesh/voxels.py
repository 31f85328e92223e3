"""Voxel volume container.

Counterpart of ``sdfkit_tpu/mesh/voxels.py``: a plain dataclass of tensors.
``save`` writes the JAX package's ``.npz`` keys (``values``, ``colors``,
``vmin``, ``vmax``, float32), so a volume written by one package loads in the
other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdfkit_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Voxels:
    """A regular 3-D grid of distance values and colours with world bounds.

    ``values``: (nx, ny, nz) float32 signed distances at cell centres.
    ``colors``: (nx, ny, nz, 3) float32 RGB. ``vmin`` / ``vmax``: (3,) world
    bounds. Cell sizes are ``size / n``."""

    values: torch.Tensor
    colors: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor

    @property
    def nx(self) -> int:
        return self.values.shape[0]

    @property
    def ny(self) -> int:
        return self.values.shape[1]

    @property
    def nz(self) -> int:
        return self.values.shape[2]

    @property
    def size(self) -> torch.Tensor:
        return self.vmax - self.vmin

    @property
    def center(self) -> torch.Tensor:
        return (self.vmin + self.vmax) * 0.5

    @property
    def radius(self) -> float:
        return float(torch.linalg.vector_norm(self.size) * 0.5)

    @property
    def d(self) -> torch.Tensor:
        n = torch.tensor([self.nx, self.ny, self.nz], dtype=torch.float32, device=self.vmin.device)
        return self.size / n

    def clip_to_bounds(self) -> "Voxels":
        from sdfkit_tpu_torch.grid import clip_values_to_bounds

        return dataclasses.replace(
            self, values=clip_values_to_bounds(self.values, self.vmin, self.vmax)
        )

    def value_at(self, p) -> float:
        """World-space indexer: the value of the cell that holds ``p``."""
        p = np.asarray(p, np.float32)
        d = self.d.cpu().numpy()
        idx = ((p - self.vmin.cpu().numpy()) / d).astype(np.int32)
        return float(self.values[idx[0], idx[1], idx[2]])

    def to_mesh(self, iso_value: float = 0.0, step: int = 1, progress=None):
        """The iso-surface mesh: marching cubes with its dense phase on the
        volume's device (``mesh/marching_cubes.py``)."""
        from sdfkit_tpu_torch.mesh.marching_cubes import create_mesh

        return create_mesh(self, iso_value=iso_value, step=step, progress=progress)

    def save(self, path) -> None:
        """Persist the volume as a compressed .npz archive."""
        np.savez_compressed(
            path,
            **{k: getattr(self, k).detach().cpu().numpy().astype(np.float32)
               for k in ("values", "colors", "vmin", "vmax")},
        )

    @classmethod
    def load(cls, path, device=None) -> "Voxels":
        """A volume from ``save``'s archive (or the JAX package's), on
        ``device`` or the package's default device."""
        device = resolve(device)
        with np.load(path) as z:
            return cls(**{k: torch.from_numpy(z[k].astype(np.float32)).to(device)
                          for k in ("values", "colors", "vmin", "vmax")})
