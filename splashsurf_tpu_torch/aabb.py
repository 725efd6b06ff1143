"""Axis-aligned bounding boxes (PyTorch port of ``splashsurf_tpu.aabb``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Aabb3d:
    """An axis-aligned bounding box given by its min/max corner (host values)."""

    min: tuple[float, float, float]
    max: tuple[float, float, float]

    def __post_init__(self):
        object.__setattr__(self, "min", tuple(float(x) for x in self.min))
        object.__setattr__(self, "max", tuple(float(x) for x in self.max))

    @staticmethod
    def from_points(points) -> "Aabb3d":
        """Smallest AABB enclosing the (N, 3) points. A tensor is reduced on
        its own device and only the two corners come to the host."""
        if isinstance(points, torch.Tensor):
            lo, hi = torch.aminmax(points, dim=0)
            lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        else:
            points = np.asarray(points)
            lo, hi = points.min(axis=0), points.max(axis=0)
        return Aabb3d(tuple(lo.tolist()), tuple(hi.tolist()))

    @property
    def mins(self) -> np.ndarray:
        return np.asarray(self.min, dtype=np.float64)

    @property
    def maxs(self) -> np.ndarray:
        return np.asarray(self.max, dtype=np.float64)

    def is_consistent(self) -> bool:
        return bool(np.all(self.maxs >= self.mins))

    def is_degenerate(self) -> bool:
        return bool(np.any(self.maxs <= self.mins))

    def contains_points(self, points: torch.Tensor) -> torch.Tensor:
        """Inclusive membership test: (N, 3) -> (N,) bool on the points' device."""
        lo = torch.tensor(self.min, dtype=points.dtype, device=points.device)
        hi = torch.tensor(self.max, dtype=points.dtype, device=points.device)
        return torch.all((points >= lo) & (points <= hi), dim=-1)

    def grow_uniformly(self, margin: float) -> "Aabb3d":
        m = float(margin)
        return Aabb3d(tuple(v - m for v in self.min), tuple(v + m for v in self.max))


def aabb_from_points(points: torch.Tensor):
    """(N, 3) -> ((3,), (3,)) min / max corners, reduced on the points'
    device (no host transfer)."""
    return torch.aminmax(points, dim=0)
