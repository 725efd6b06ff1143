"""Surface reconstruction entry point (PyTorch port of
``splashsurf_tpu.reconstruction``; reference API: lib.rs:330-473).

The entry points run on the card unless the caller asks for the CPU: a
tensor input runs on its own device; any other input goes to ``device=``,
by default CUDA, and where CUDA is absent that raises RuntimeError, never
falling back to the CPU. The dense global route, the x-slab route
(grids past the dense gate on one device) and the subdomain-grid route
(sharded over the process's devices where there are several) are ported,
and the route is chosen as the reference package chooses it; every route fills
``particle_neighbors`` when ``global_neighborhood_list`` asks for it.
``reconstruct_sequence`` runs frames in order, each frame's mesh copy
overlapping the next frame's first stages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.neighbors import NeighborhoodLists
from splashsurf_tpu_torch.params import Parameters, SpatialDecomposition
from splashsurf_tpu_torch.placement import as_device_tensor
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# The dense route's guard: the largest grid it materializes
# (reconstruction.py:406 of the reference, not an environment switch).
GLOBAL_DENSE_GUARD_CELLS = 128_000_000


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def global_dense_max_cells() -> int:
    """Largest grid (cells) routed to the dense global pipeline
    (``SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS``, default 160M; the
    reference's reconstruction.py:186-199)."""
    return _env_int("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", 160_000_000)


@dataclasses.dataclass
class SurfaceReconstruction:
    """Result of a surface reconstruction (lib.rs:246-277): the grid, the
    host mesh, the per-particle densities (a device tensor), the particle
    neighbour lists (with ``global_neighborhood_list``) and the AABB filter
    mask, if one was applied.

    With a deferred mesh pull (``reconstruct_surface(..., _defer_pull=True)``,
    used by ``reconstruct_sequence``) ``mesh`` is None until ``resolve()``
    finishes the copy; the sequence resolves every frame before it yields
    it."""

    grid: UniformGrid
    mesh: Optional[TriMesh3d]
    subdomain_grid: Optional[UniformGrid] = None
    particle_densities: Optional[torch.Tensor] = None
    particle_neighbors: Optional[NeighborhoodLists] = None
    particle_inside_aabb: Optional[np.ndarray] = None
    _pending_mesh: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    def resolve(self) -> "SurfaceReconstruction":
        """Finish a deferred mesh pull (no-op when there is none)."""
        if self._pending_mesh is not None:
            pull, self._pending_mesh = self._pending_mesh, None
            self.mesh = pull.resolve()
        return self


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
    """The bucketed grid, or ``grid`` itself with
    ``SPLASHSURF_TPU_GRID_BUCKET=0`` (reconstruction.py:178 of the
    reference)."""
    if os.environ.get("SPLASHSURF_TPU_GRID_BUCKET", "1") == "0":
        return grid
    dims = tuple(_bucket_grid_dim(int(c)) for c in grid.n_cells)
    if dims == grid.n_cells:
        return grid
    return UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=dims)


def choose_route(parameters: Parameters, grid: UniformGrid, n_devices: int = 1) -> str:
    """The route the reference package takes for this grid
    (reconstruction.py:330-411): "dense", "slab" or "subdomain"; raises
    ValueError where the dense route would materialize too large a grid.

    The switches are read at each call, with the reference's defaults:
    ``SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS`` (the dense gate),
    ``SPLASHSURF_TPU_SLAB_DENSE`` ("1": slabs past the gate),
    ``SPLASHSURF_TPU_SLAB_MAX_SLABS`` and ``SPLASHSURF_TPU_SLAB_CELLS_BUDGET``.
    As in the reference, slabs need a single device: with ``n_devices`` > 1
    (the process's devices of the positions' type, ``parallel.mesh.devices``)
    a grid past the dense gate takes the subdomain route, which shards."""
    from splashsurf_tpu_torch.ops.slab_sweep import slab_cells_budget, slab_width_cells

    route = "dense"
    if parameters.spatial_decomposition == SpatialDecomposition.UNIFORM_GRID:
        gd = parameters.grid_decomposition
        route = "subdomain"
        if gd.auto_disable:
            if max(grid.n_cells) <= 1.2 * gd.subdomain_num_cubes_per_dim:
                route = "dense"  # hardly larger than one subdomain
            elif grid.total_cells <= global_dense_max_cells():
                route = "dense"
            elif (
                os.environ.get("SPLASHSURF_TPU_SLAB_DENSE", "1") == "1"
                and n_devices == 1
                and int(np.prod(np.asarray(grid.n_points, np.int64))) < 2**31
            ):
                n_slabs = -(-grid.n_cells[0] // slab_width_cells(grid, slab_cells_budget()))
                if n_slabs <= _env_int("SPLASHSURF_TPU_SLAB_MAX_SLABS", 64):
                    route = "slab"
    if route == "dense" and grid.total_cells > GLOBAL_DENSE_GUARD_CELLS:
        raise ValueError(
            f"global reconstruction would materialize a dense {grid.n_cells} "
            f"grid ({grid.total_cells} cells); use "
            "SpatialDecomposition.UNIFORM_GRID for domains this large"
        )
    return route


def reconstruct_surface(
    particle_positions, parameters: Parameters, device=None, _defer_pull: bool = False
) -> SurfaceReconstruction:
    """Reconstruct a closed triangle mesh of the fluid surface.

    ``particle_positions`` is an (N, 3) tensor, which runs on its own
    device, or an array, which runs on ``device`` (default CUDA). Returns
    the mesh as host numpy arrays.

    ``_defer_pull`` (used by ``reconstruct_sequence``): on the dense route,
    start the mesh copy and return with ``mesh`` None; ``resolve()`` waits
    for it. The slab and subdomain routes pull their mesh before they
    return, so there it changes nothing.
    """
    from splashsurf_tpu_torch.global_pipeline import reconstruct_surface_global
    from splashsurf_tpu_torch.ops.slab_sweep import reconstruct_surface_slabbed
    from splashsurf_tpu_torch.parallel.mesh import devices
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
    route = choose_route(parameters, grid, len(devices(positions.device.type)))
    if route == "subdomain":
        return reconstruct_surface_subdomain_grid(
            positions, parameters, grid, particle_inside_aabb=inside_aabb
        )
    if route == "slab":
        return reconstruct_surface_slabbed(
            positions, parameters, grid, particle_inside_aabb=inside_aabb
        )
    return reconstruct_surface_global(
        positions, parameters, grid, particle_inside_aabb=inside_aabb,
        defer_pull=_defer_pull,
    )


def reconstruct_sequence(
    frames: Iterable, parameters: Parameters, device=None
) -> Iterator[SurfaceReconstruction]:
    """Reconstruct a sequence of frames (reconstruction.py:493-514 of the
    reference): a generator of resolved results, one per frame, in order.

    Frame t+1 is dispatched before frame t's mesh is resolved, so frame t's
    mesh copy (on a side stream, into pinned host memory) overlaps frame
    t+1's first stages. Eager PyTorch reads counts back inside a frame (the
    overflow count, the density plan, marching cubes), so the overlap covers
    only the mesh copy against the next frame's first stages.
    ``SPLASHSURF_TPU_PIPELINE=0`` runs frame at a time. Each frame goes
    through ``reconstruct_surface`` with ``device``.
    """
    pipeline = os.environ.get("SPLASHSURF_TPU_PIPELINE", "1") != "0"
    prev = None
    for pts in frames:
        cur = reconstruct_surface(pts, parameters, device=device, _defer_pull=pipeline)
        if prev is not None:
            yield prev.resolve()
        prev = cur
    if prev is not None:
        yield prev.resolve()
