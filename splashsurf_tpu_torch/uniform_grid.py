"""Implicit uniform cube grid (PyTorch port of ``splashsurf_tpu.uniform_grid``).

The grid is a host-side value: AABB min, cell size and cell counts. Index
flattening follows the reference convention ``i*ny*nz + j*nz + k``
(uniform_grid.rs:342-411).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.kernels import rounded

_CELL_CLAMP = float(2**40)


@dataclasses.dataclass(frozen=True)
class KernelExtents:
    """Grid extents affected by a particle's kernel support
    (``compute_kernel_evaluation_radius``, density_map.rs:551-580)."""

    half_supported_cells: int
    supported_points: int
    kernel_evaluation_radius: float


def kernel_extents(
    compact_support_radius: float, cube_size: float, dtype=np.float32
) -> KernelExtents:
    if compact_support_radius < 0.0 or cube_size <= 0.0:
        raise ValueError(
            f"invalid support {compact_support_radius} / cube {cube_size}"
        )
    half_supported_cells = int(math.ceil(compact_support_radius / cube_size))
    supported_points = 2 * half_supported_cells + 2
    eps = float(np.sqrt(np.finfo(np.dtype(dtype)).eps))
    kernel_evaluation_radius = cube_size * half_supported_cells * (1.0 + eps)
    return KernelExtents(
        half_supported_cells=half_supported_cells,
        supported_points=supported_points,
        kernel_evaluation_radius=float(kernel_evaluation_radius),
    )


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """Implicit uniform cube grid: ``n_cells`` cells and ``n_cells + 1``
    points per dimension."""

    min: Tuple[float, float, float]
    cell_size: float
    n_cells: Tuple[int, int, int]

    def __post_init__(self):
        object.__setattr__(self, "min", tuple(float(x) for x in self.min))
        object.__setattr__(self, "cell_size", float(self.cell_size))
        object.__setattr__(self, "n_cells", tuple(int(x) for x in self.n_cells))

    @staticmethod
    def from_aabb(aabb: Aabb3d, cell_size: float) -> "UniformGrid":
        """Grid enclosing ``aabb``, min aligned down to integer multiples of
        ``cell_size`` (uniform_grid.rs:188-194)."""
        if not cell_size > 0.0:
            raise ValueError(f"invalid cell size {cell_size}")
        if aabb.is_degenerate() or not aabb.is_consistent():
            raise ValueError(f"degenerate or inconsistent AABB: {aabb}")
        aligned_min = np.floor(aabb.mins / cell_size) * cell_size
        n_cells = np.ceil((aabb.maxs - aligned_min) / cell_size).astype(np.int64)
        n_cells = np.maximum(n_cells, 1)
        return UniformGrid(
            min=tuple(aligned_min.tolist()),
            cell_size=cell_size,
            n_cells=tuple(int(c) for c in n_cells),
        )

    @property
    def n_points(self) -> Tuple[int, int, int]:
        return tuple(c + 1 for c in self.n_cells)

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.n_cells
        return nx * ny * nz

    def enclosing_cell(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3) positions -> (..., 3) int64 indices of the cells that
        contain them, floor((x - min) / cell_size) in the positions' dtype.
        Positions outside the grid give indices outside [0, n_cells), as the
        reference's ghost classification needs (dense_subdomains.rs:667);
        they are clamped to +-2^40 only so that far sentinels stay integers."""
        dtype = x.dtype
        mn = torch.tensor([rounded(m, dtype) for m in self.min], dtype=dtype, device=x.device)
        q = torch.floor((x - mn) / rounded(self.cell_size, dtype))
        return q.clamp(-_CELL_CLAMP, _CELL_CLAMP).to(torch.int64)

    def flatten_cell_index(self, ijk: torch.Tensor) -> torch.Tensor:
        """Flat int64 cell index i*ny*nz + j*nz + k of (..., 3) indices."""
        _, ny, nz = self.n_cells
        return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
