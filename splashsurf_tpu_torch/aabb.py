"""Axis-aligned bounding boxes (PyTorch port of ``splashsurf_tpu.aabb``)."""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.profiling import to_host


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
            lo, hi = to_host(torch.stack(torch.aminmax(points, dim=0))).numpy()
        else:
            points = np.asarray(points)
            lo, hi = points.min(axis=0), points.max(axis=0)
        return Aabb3d(tuple(lo.tolist()), tuple(hi.tolist()))

    @staticmethod
    def par_from_points(points) -> "Aabb3d":
        """``from_points``: the reduction runs in parallel on every device."""
        return Aabb3d.from_points(points)

    @staticmethod
    def from_min_max(min, max) -> "Aabb3d":
        """AABB with the given min and max corners (pysplashsurf.pyi:29)."""
        return Aabb3d(tuple(min), tuple(max))

    @property
    def mins(self) -> np.ndarray:
        return np.asarray(self.min, dtype=np.float64)

    @property
    def maxs(self) -> np.ndarray:
        return np.asarray(self.max, dtype=np.float64)

    def extents(self) -> np.ndarray:
        return self.maxs - self.mins

    def centroid(self) -> np.ndarray:
        return 0.5 * (self.mins + self.maxs)

    def is_consistent(self) -> bool:
        return bool(np.all(self.maxs >= self.mins))

    def is_degenerate(self) -> bool:
        return bool(np.any(self.maxs <= self.mins))

    def contains_point(self, x) -> bool:
        """Inclusive membership test of one point (aabb.rs ``contains_point``)."""
        x = np.asarray(x, dtype=np.float64)
        return bool(np.all(x >= self.mins) and np.all(x <= self.maxs))

    def contains_points(self, points, device=None) -> torch.Tensor:
        """Inclusive membership test: (N, 3) -> (N,) bool on the points'
        device (``placement.on_device``)."""
        points = on_device(points, device=device)
        lo = torch.tensor(self.min, dtype=points.dtype, device=points.device)
        hi = torch.tensor(self.max, dtype=points.dtype, device=points.device)
        return torch.all((points >= lo) & (points <= hi), dim=-1)

    def grow_uniformly(self, margin: float) -> "Aabb3d":
        m = float(margin)
        return Aabb3d(tuple(v - m for v in self.min), tuple(v + m for v in self.max))

    def join(self, other: "Aabb3d") -> "Aabb3d":
        return Aabb3d(
            tuple(np.minimum(self.mins, other.mins).tolist()),
            tuple(np.maximum(self.maxs, other.maxs).tolist()),
        )

    @staticmethod
    def join_all(boxes: Iterable["Aabb3d"]) -> "Aabb3d":
        boxes = list(boxes)
        out = boxes[0]
        for b in boxes[1:]:
            out = out.join(b)
        return out


def aabb_from_points(points, device=None):
    """(N, 3) -> ((3,), (3,)) min / max corners, reduced on the points'
    device (``placement.on_device``; no host transfer)."""
    return torch.aminmax(on_device(points, device=device), dim=0)
