"""Reconstruction parameters (PyTorch port of ``splashsurf_tpu.params``).

Frozen dataclasses mirroring the reference's ``Parameters<R>``
(splashsurf_lib/src/lib.rs:157-243). All distances are absolute; use
:meth:`Parameters.new_relative` for the CLI-style parameterization relative
to the particle radius.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch.aabb import Aabb3d


class SpatialDecomposition(enum.Enum):
    """``NONE``: one dense global grid; ``UNIFORM_GRID``: cubic subdomains."""

    NONE = "none"
    UNIFORM_GRID = "uniform_grid"


@dataclasses.dataclass(frozen=True)
class GridDecompositionParameters:
    """Parameters of the uniform-grid subdomain decomposition (lib.rs:138-154)."""

    subdomain_num_cubes_per_dim: int = 64
    auto_disable: bool = True


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Parameters for the surface reconstruction (lib.rs:157-243)."""

    particle_radius: float
    compact_support_radius: float
    cube_size: float
    rest_density: float = 1000.0
    iso_surface_threshold: float = 0.6
    particle_aabb: Optional[Aabb3d] = None
    spatial_decomposition: SpatialDecomposition = SpatialDecomposition.UNIFORM_GRID
    grid_decomposition: GridDecompositionParameters = GridDecompositionParameters()
    global_neighborhood_list: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if not self.cube_size > 0.0:
            raise ValueError(f"cube_size must be positive, got {self.cube_size}")
        if not self.compact_support_radius > 0.0:
            raise ValueError(
                f"compact_support_radius must be positive, got {self.compact_support_radius}"
            )
        if not self.particle_radius > 0.0:
            raise ValueError(
                f"particle_radius must be positive, got {self.particle_radius}"
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")

    @staticmethod
    def new(
        particle_radius: float, compact_support_radius: float, cube_size: float, **kw
    ) -> "Parameters":
        return Parameters(
            particle_radius=particle_radius,
            compact_support_radius=compact_support_radius,
            cube_size=cube_size,
            **kw,
        )

    @staticmethod
    def new_relative(
        particle_radius: float,
        relative_compact_support_radius: float,
        relative_cube_size: float,
        **kw,
    ) -> "Parameters":
        """Parameters relative to the particle radius (lib.rs:216-226)."""
        return Parameters(
            particle_radius=particle_radius,
            compact_support_radius=particle_radius * relative_compact_support_radius,
            cube_size=particle_radius * relative_cube_size,
            **kw,
        )

    @staticmethod
    def from_reference(p) -> "Parameters":
        """Copy any object with the ``Parameters`` fields (the JAX package's
        ``Parameters`` included) into this package's type. Enums are mapped
        by value and the AABB by its corners, so nothing of the source
        package is imported."""
        aabb = p.particle_aabb
        gd = p.grid_decomposition
        return Parameters(
            particle_radius=float(p.particle_radius),
            compact_support_radius=float(p.compact_support_radius),
            cube_size=float(p.cube_size),
            rest_density=float(p.rest_density),
            iso_surface_threshold=float(p.iso_surface_threshold),
            particle_aabb=None if aabb is None else Aabb3d(aabb.min, aabb.max),
            spatial_decomposition=SpatialDecomposition(
                p.spatial_decomposition.value
            ),
            grid_decomposition=GridDecompositionParameters(
                subdomain_num_cubes_per_dim=int(gd.subdomain_num_cubes_per_dim),
                auto_disable=bool(gd.auto_disable),
            ),
            global_neighborhood_list=bool(p.global_neighborhood_list),
            dtype=str(p.dtype),
        )

    @property
    def particle_rest_volume(self) -> float:
        """Volume of a particle modeled as a cube of fluid, (2r)^3 (kernel.rs:28-30)."""
        return float((2.0 * self.particle_radius) ** 3)

    @property
    def particle_rest_mass(self) -> float:
        return self.particle_rest_volume * float(self.rest_density)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    def try_convert(self, dtype: str) -> "Parameters":
        return dataclasses.replace(self, dtype=dtype)
