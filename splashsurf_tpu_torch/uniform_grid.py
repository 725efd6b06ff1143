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
from splashsurf_tpu_torch.placement import on_device

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

    def ncells_per_dim(self) -> list:
        """pysplashsurf.pyi parity: cells per dimension as a list."""
        return list(self.n_cells)

    def npoints_per_dim(self) -> list:
        """pysplashsurf.pyi:295 parity: points per dimension as a list."""
        return list(self.n_points)

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.n_cells
        return nx * ny * nz

    @property
    def total_points(self) -> int:
        nx, ny, nz = self.n_points
        return nx * ny * nz

    def aabb(self) -> Aabb3d:
        mx = tuple(m + c * self.cell_size for m, c in zip(self.min, self.n_cells))
        return Aabb3d(self.min, mx)

    # The tensor methods below run on their input's device
    # (``placement.on_device``: an array goes to ``device``, by default CUDA).

    def point_coordinates(self, ijk, dtype=torch.float32, device=None) -> torch.Tensor:
        """(..., 3) grid point indices -> (..., 3) coordinates min + ijk *
        cell_size in ``dtype`` (a torch or numpy float dtype): the product
        and the sum each rounded, as the reference computes them."""
        ijk = on_device(ijk, device=device)
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        mn = torch.tensor([rounded(m, dtype) for m in self.min], dtype=dtype, device=ijk.device)
        return mn + ijk.to(dtype) * rounded(self.cell_size, dtype)

    def enclosing_cell(self, x, device=None) -> torch.Tensor:
        """(..., 3) positions -> (..., 3) int64 indices of the cells that
        contain them, floor((x - min) / cell_size) in the positions' dtype.
        Positions outside the grid give indices outside [0, n_cells), as the
        reference's ghost classification needs (dense_subdomains.rs:667);
        they are clamped to +-2^40 only so that far sentinels stay integers."""
        x = on_device(x, device=device)
        dtype = x.dtype
        mn = torch.tensor([rounded(m, dtype) for m in self.min], dtype=dtype, device=x.device)
        q = torch.floor((x - mn) / rounded(self.cell_size, dtype))
        return q.clamp(-_CELL_CLAMP, _CELL_CLAMP).to(torch.int64)

    @staticmethod
    def _flatten(ijk: torch.Tensor, dims) -> torch.Tensor:
        _, ny, nz = dims
        return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]

    @staticmethod
    def _unflatten(flat: torch.Tensor, dims) -> torch.Tensor:
        _, ny, nz = dims
        return torch.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz], dim=-1)

    def flatten_point_index(self, ijk, device=None) -> torch.Tensor:
        """Flat point index i*ny*nz + j*nz + k of (..., 3) indices, in
        their integer dtype (torch keeps it against Python ints)."""
        return self._flatten(on_device(ijk, device=device), self.n_points)

    def flatten_cell_index(self, ijk, device=None) -> torch.Tensor:
        """Flat cell index i*ny*nz + j*nz + k of (..., 3) indices, in their
        integer dtype."""
        return self._flatten(on_device(ijk, device=device), self.n_cells)

    def unflatten_point_index(self, flat, device=None) -> torch.Tensor:
        return self._unflatten(on_device(flat, device=device), self.n_points)

    def unflatten_cell_index(self, flat, device=None) -> torch.Tensor:
        return self._unflatten(on_device(flat, device=device), self.n_cells)

    @staticmethod
    def _inside(ijk: torch.Tensor, dims) -> torch.Tensor:
        return torch.all((ijk >= 0) & (ijk < ijk.new_tensor(dims)), dim=-1)

    @staticmethod
    def _on_boundary(ijk: torch.Tensor, dims) -> torch.Tensor:
        last = ijk.new_tensor(dims) - 1
        return torch.any((ijk == 0) | (ijk == last), dim=-1)

    def point_in_grid(self, ijk, device=None) -> torch.Tensor:
        return self._inside(on_device(ijk, device=device), self.n_points)

    def cell_in_grid(self, ijk, device=None) -> torch.Tensor:
        return self._inside(on_device(ijk, device=device), self.n_cells)

    def is_boundary_point(self, ijk, device=None) -> torch.Tensor:
        return self._on_boundary(on_device(ijk, device=device), self.n_points)

    def is_boundary_cell(self, ijk, device=None) -> torch.Tensor:
        return self._on_boundary(on_device(ijk, device=device), self.n_cells)
