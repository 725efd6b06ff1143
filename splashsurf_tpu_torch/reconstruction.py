"""Surface reconstruction entry point (PyTorch port of
``splashsurf_tpu.reconstruction``; reference API: lib.rs:330-473).

The device is explicit: a tensor input runs on its own device, a numpy
input needs ``device=``. The dense global route and the subdomain-grid
route are ported, and the route is chosen as the reference package chooses
it; inputs that it would send down the slab route raise
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
# The reference's slab route: slabs of at most this many cells
# (ops/slab_sweep.py:450), taken for at most this many slabs on grids of
# fewer than 2^31 points.
SLAB_CELLS_BUDGET = 48_000_000
SLAB_MAX_SLABS = 64


@dataclasses.dataclass
class SurfaceReconstruction:
    """Result of a surface reconstruction (lib.rs:246-277): the grid, the
    host mesh, the per-particle densities (a device tensor) and the AABB
    filter mask, if one was applied."""

    grid: UniformGrid
    mesh: TriMesh3d
    subdomain_grid: Optional[UniformGrid] = None
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


def slab_width_cells(grid: UniformGrid, max_cells: int) -> int:
    """The reference's slab width in cells (ops/slab_sweep.py:51): one
    slab's cells stay within ``max_cells``; at least 8 cells, at most the
    whole grid."""
    _, ncy, ncz = grid.n_cells
    return int(max(8, min(grid.n_cells[0], max_cells // max(1, ncy * ncz))))


def choose_route(parameters: Parameters, grid: UniformGrid) -> str:
    """The route the reference package takes for this grid
    (reconstruction.py:330-411): "dense" or "subdomain"; raises
    NotImplementedError where it would take the slab route, and ValueError
    where the dense route would materialize too large a grid."""
    route = "dense"
    if parameters.spatial_decomposition == SpatialDecomposition.UNIFORM_GRID:
        gd = parameters.grid_decomposition
        route = "subdomain"
        if gd.auto_disable:
            if max(grid.n_cells) <= 1.2 * gd.subdomain_num_cubes_per_dim:
                route = "dense"  # hardly larger than one subdomain
            elif grid.total_cells <= GLOBAL_DENSE_MAX_CELLS:
                route = "dense"
            elif int(np.prod(np.asarray(grid.n_points, np.int64))) < 2**31:
                n_slabs = -(-grid.n_cells[0] // slab_width_cells(grid, SLAB_CELLS_BUDGET))
                if n_slabs <= SLAB_MAX_SLABS:
                    raise NotImplementedError(
                        f"grid {grid.n_cells} ({grid.total_cells} cells) is past the "
                        f"dense gate of {GLOBAL_DENSE_MAX_CELLS} cells and fits "
                        f"{n_slabs} slabs: the reference takes the slab route there, "
                        "which is not ported yet; see ROADMAP.md"
                    )
    if route == "dense" and grid.total_cells > GLOBAL_DENSE_GUARD_CELLS:
        raise ValueError(
            f"global reconstruction would materialize a dense {grid.n_cells} "
            f"grid ({grid.total_cells} cells); use "
            "SpatialDecomposition.UNIFORM_GRID for domains this large"
        )
    return route


def reconstruct_surface(
    particle_positions, parameters: Parameters, device=None
) -> SurfaceReconstruction:
    """Reconstruct a closed triangle mesh of the fluid surface.

    ``particle_positions`` is an (N, 3) tensor, which runs on its own
    device, or an array, which needs ``device``. Returns the mesh as host
    numpy arrays.
    """
    from splashsurf_tpu_torch.global_pipeline import reconstruct_surface_global
    from splashsurf_tpu_torch.subdomains import reconstruct_surface_subdomain_grid

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
    if choose_route(parameters, grid) == "subdomain":
        return reconstruct_surface_subdomain_grid(
            positions, parameters, grid, particle_inside_aabb=inside_aabb
        )
    return reconstruct_surface_global(
        positions, parameters, grid, particle_inside_aabb=inside_aabb
    )
