"""Surface reconstruction entry point (PyTorch port of the dense route of
``splashsurf_tpu.reconstruction``; reference API: lib.rs:330-473).

The device is explicit: a tensor input runs on its own device, a numpy
input needs ``device=``. Only the dense global route is ported; inputs that
the reference package would send down another route raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.params import Parameters, SpatialDecomposition
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# Largest grid (cells) the reference routes to the dense global pipeline,
# and the largest it lets that pipeline materialize.
GLOBAL_DENSE_MAX_CELLS = 160_000_000
GLOBAL_DENSE_GUARD_CELLS = 128_000_000


@dataclasses.dataclass
class SurfaceReconstruction:
    """Result of a surface reconstruction (lib.rs:246-277): the grid, the
    host mesh, the per-particle densities (a device tensor) and the AABB
    filter mask, if one was applied."""

    grid: UniformGrid
    mesh: TriMesh3d
    particle_densities: Optional[torch.Tensor] = None
    particle_inside_aabb: Optional[np.ndarray] = None


def as_device_tensor(x, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor stays on its own device (``device``, if given, must agree);
    anything else becomes a tensor on ``device``, which is then required."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            want = torch.device(device)
            if want.type != x.device.type or (
                want.index is not None and want.index != x.device.index
            ):
                raise ValueError(f"tensor on {x.device} but device={want}")
        return x if dtype is None else x.to(dtype)
    if device is None:
        raise ValueError("a non-tensor input needs an explicit device=")
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def grid_for_reconstruction(
    particle_positions,
    particle_radius: float,
    compact_support_radius: float,
    cube_size: float,
    particle_aabb: Optional[Aabb3d] = None,
) -> UniformGrid:
    """The background grid for marching cubes (lib.rs:476-516): the particle
    AABB grown by the particle radius and the kernel evaluation radius, so
    every particle's support lies inside and the surface closes."""
    if particle_aabb is None:
        aabb = Aabb3d.from_points(particle_positions).grow_uniformly(particle_radius)
    else:
        aabb = particle_aabb
    margin = kernel_extents(compact_support_radius, cube_size).kernel_evaluation_radius
    return UniformGrid.from_aabb(aabb.grow_uniformly(margin), cube_size)


def _bucket_grid_dim(n: int) -> int:
    """Round a grid dimension up to its bucket (16 steps per octave, at
    least 8 cells). The padded cells lie beyond the particle margin and hold
    no surface; the port keeps the bucketing so that it routes and meshes
    exactly the grid the reference package does."""
    step = max(8, 1 << max(n.bit_length() - 5, 3))
    return -(-n // step) * step


def _bucket_grid(grid: UniformGrid) -> UniformGrid:
    dims = tuple(_bucket_grid_dim(int(c)) for c in grid.n_cells)
    if dims == grid.n_cells:
        return grid
    return UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=dims)


def _check_dense_route(parameters: Parameters, grid: UniformGrid) -> None:
    """Raise unless the reference package would take the dense global route
    (reconstruction.py:330-347, 406-411) for this grid."""
    decomposition = parameters.spatial_decomposition
    if decomposition == SpatialDecomposition.UNIFORM_GRID:
        gd = parameters.grid_decomposition
        if not gd.auto_disable:
            raise NotImplementedError(
                "the subdomain route (spatial decomposition without "
                "auto_disable) is not ported yet; see ROADMAP.md"
            )
        small = max(grid.n_cells) <= 1.2 * gd.subdomain_num_cubes_per_dim
        if not small and grid.total_cells > GLOBAL_DENSE_MAX_CELLS:
            raise NotImplementedError(
                f"grid {grid.n_cells} ({grid.total_cells} cells) is past the "
                f"dense gate of {GLOBAL_DENSE_MAX_CELLS} cells: the slab and "
                "subdomain routes are not ported yet; see ROADMAP.md"
            )
    if grid.total_cells > GLOBAL_DENSE_GUARD_CELLS:
        raise ValueError(
            f"global reconstruction would materialize a dense {grid.n_cells} "
            f"grid ({grid.total_cells} cells); use "
            "SpatialDecomposition.UNIFORM_GRID for domains this large"
        )


def reconstruct_surface(
    particle_positions, parameters: Parameters, device=None
) -> SurfaceReconstruction:
    """Reconstruct a closed triangle mesh of the fluid surface.

    ``particle_positions`` is an (N, 3) tensor, which runs on its own
    device, or an array, which needs ``device``. Returns the mesh as host
    numpy arrays.
    """
    from splashsurf_tpu_torch.global_pipeline import reconstruct_surface_global

    positions = as_device_tensor(
        particle_positions, device, parameters.torch_dtype
    ).contiguous()
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(
            f"particle positions must have shape (N, 3), got {tuple(positions.shape)}"
        )
    if positions.shape[0] == 0:
        raise ValueError("cannot reconstruct a surface from zero particles")
    if parameters.global_neighborhood_list:
        raise NotImplementedError(
            "global_neighborhood_list is not ported yet; see ROADMAP.md"
        )

    inside_aabb = None
    if parameters.particle_aabb is not None:
        mask = parameters.particle_aabb.contains_points(positions)
        inside_aabb = mask.cpu().numpy()
        positions = positions[mask]

    grid = _bucket_grid(
        grid_for_reconstruction(
            positions,
            parameters.particle_radius,
            parameters.compact_support_radius,
            parameters.cube_size,
            parameters.particle_aabb,
        )
    )
    _check_dense_route(parameters, grid)
    return reconstruct_surface_global(
        positions, parameters, grid, particle_inside_aabb=inside_aabb
    )
