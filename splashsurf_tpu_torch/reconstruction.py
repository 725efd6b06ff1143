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

A tensor input on the dense route runs on the background grid of the
frame before it with the same (N, dtype, radii, cube size), as the
reference's device arrays do (the grid plan, reconstruction.py:53-76,
240-275 of the reference): its AABB is not read back; a device check that
the grid still holds comes back with the mesh, and a miss re-derives the
grid and runs the frame again. Unlike the reference, a key whose grid
moved within its last few frames (``plans.reads_grid``) reads its grid
before the frame instead: the same grid and mesh as the miss's second
attempt, without the first.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from splashsurf_tpu_torch import kernels, plans
from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.neighbors import NeighborhoodLists
from splashsurf_tpu_torch.params import Parameters, SpatialDecomposition
from splashsurf_tpu_torch.placement import as_device_tensor
from splashsurf_tpu_torch.profiling import profile, redo_span, to_host
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
    finishes the copy (where the frame's plans missed, it runs the frame
    again and takes its grid and densities too); the sequence resolves
    every frame before it yields it."""

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
            fn, self._pending_mesh = self._pending_mesh, None
            self.mesh = fn()
        return self


class GridPlanMiss(RuntimeError):
    """A speculated background grid no longer matches the particle AABB."""


def clear_grid_plan() -> None:
    """Forget the grid plans and the warmed keys, and drop the warm frames'
    CUDA graphs: ``plans.clear_grid``."""
    plans.clear_grid()


def _grid_check_device(positions: torch.Tensor, grid: UniformGrid, grow: float, raw_nc):
    """Device bool: would ``grid_for_reconstruction`` on these positions give
    ``grid`` (whose unbucketed cell counts are ``raw_nc``)? A copy of the
    reference's ``_grid_check_device_impl`` (reconstruction.py:98-134),
    conservative as it is: alignment quantities within 16 float32 ulps of an
    integer, where the device's arithmetic in the positions' dtype could
    round otherwise than the host's float64, report a miss."""
    dtype = positions.dtype
    r = lambda x: kernels.rounded(x, dtype)
    lo, hi = torch.aminmax(positions, dim=0)
    cs = r(grid.cell_size)
    q = (lo - r(grow)) / cs
    mi = torch.floor(q)
    q2 = (hi + r(grow) - mi * cs) / cs
    nc = torch.ceil(q2)
    ulp16 = 16.0 * r(np.float32(1.2e-7))
    safe = torch.all((q - torch.round(q)).abs() > ulp16 * q.abs().clamp_min(1.0))
    safe &= torch.all((q2 - torch.round(q2)).abs() > ulp16 * q2.abs().clamp_min(1.0))
    ok = safe
    for d in range(3):
        ok &= (mi[d] == r(np.round(grid.min[d] / grid.cell_size))) & (nc[d] == raw_nc[d])
    return ok


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
    from splashsurf_tpu_torch.ops.slab_sweep import gs_dense_gate, slab_width_cells

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
                n_slabs = -(-grid.n_cells[0] // slab_width_cells(grid, gs_dense_gate()))
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
    for it, checks the frame's plans and, where one missed, runs the frame
    again with the same input. The slab and subdomain routes pull their
    mesh before they return, and so does the single-dispatch warm frame
    (``SPLASHSURF_TPU_MONO_FRAME``), so there it changes nothing.

    With the single-dispatch warm frame on (``global_pipeline.
    mono_frame_on``) and ``SPLASHSURF_TPU_PREWARM`` "1" (read per call, by
    default "1", as in the reference), a planning frame (one that records
    the grid plan of a key for the first time, on a grid it derived
    itself) then runs one discarded deferred frame on the same input, as
    the reference does (reconstruction.py:430-455): on the card that frame
    captures the warm frame's CUDA graph. Without the mono frame the
    discarded frame would build nothing, and none runs. An error in it
    raises.
    """
    with profile("frame"):
        return _reconstruct_surface(particle_positions, parameters, device, _defer_pull)


def _reconstruct_surface(particle_positions, parameters: Parameters, device,
                         _defer_pull: bool) -> SurfaceReconstruction:
    """``reconstruct_surface`` inside its "frame" span; a second attempt,
    after the grid plan missed, inside "redo grid"."""
    from splashsurf_tpu_torch.global_pipeline import (
        DeferredMesh, mono_frame_on, reconstruct_surface_global,
    )
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
        inside_aabb = to_host(mask).numpy()
        # the count is on the host now: no second read for the selection
        positions = positions[kernels.compact_indices(mask, int(inside_aabb.sum()))]

    gkey = None
    if isinstance(particle_positions, torch.Tensor) and parameters.particle_aabb is None:
        gkey = (
            int(positions.shape[0]), str(positions.dtype), float(parameters.particle_radius),
            float(parameters.compact_support_radius), float(parameters.cube_size),
        )
    rec = None
    planned_cold = False
    for attempt in range(2):
        with redo_span("grid", attempt):
            plan = plans.grid_plan(gkey) if attempt == 0 else None
            # a key whose grid keeps moving reads its grid, and meshes what
            # a miss's redo would mesh, without the attempt it throws away
            read_over = plan if plan is not None and plans.reads_grid(gkey) else None
            cached = plan is not None and read_over is None
            grid_check = None
            with profile("grid"):
                if cached:
                    grid, raw_nc = plan
                    grow = parameters.particle_radius + kernel_extents(
                        parameters.compact_support_radius, parameters.cube_size
                    ).kernel_evaluation_radius
                    grid_check = _grid_check_device(positions, grid, grow, raw_nc)
                else:
                    grid = grid_for_reconstruction(
                        positions,
                        parameters.particle_radius,
                        parameters.compact_support_radius,
                        parameters.cube_size,
                        parameters.particle_aabb,
                    )
                    raw_nc = grid.n_cells
                    grid = _bucket_grid(grid)
            route = choose_route(parameters, grid, len(devices(positions.device.type)))
            if route != "dense" and cached:
                # the slab and subdomain routes take no deferred check: go cold
                plans.GRID_PLAN.pop(gkey, None)
                continue
            if route == "subdomain":
                return reconstruct_surface_subdomain_grid(
                    positions, parameters, grid, particle_inside_aabb=inside_aabb
                )
            if route == "slab":
                return reconstruct_surface_slabbed(
                    positions, parameters, grid, particle_inside_aabb=inside_aabb
                )
            try:
                rec = reconstruct_surface_global(
                    positions, parameters, grid, particle_inside_aabb=inside_aabb,
                    grid_check=grid_check, defer_pull=_defer_pull,
                )
            except GridPlanMiss:
                plans.note_grid_miss(gkey)
                continue
            if gkey is not None:
                planned_cold = plans.note_grid(gkey, (grid, raw_nc), cached, read_over)
            break
    assert rec is not None
    if (planned_cold and mono_frame_on(positions.dtype)
            and os.environ.get("SPLASHSURF_TPU_PREWARM", "1") == "1"):
        plans.WARMED.add(gkey)
        try:
            reconstruct_surface(particle_positions, parameters, device=device, _defer_pull=True)
        except Exception:
            plans.WARMED.discard(gkey)
            raise
    if isinstance(rec._pending_mesh, DeferredMesh):
        rec._pending_mesh.redo = functools.partial(
            _redo_frame, gkey, particle_positions, parameters, device
        )
    return rec


def _redo_frame(gkey, particle_positions, parameters, device, code: str):
    """A deferred frame whose plans missed, run again synchronously with its
    original input (reference reconstruction.py:465-490)."""
    if code == "redo_grid" and gkey is not None:
        plans.note_grid_miss(gkey)
    return reconstruct_surface(particle_positions, parameters, device=device)


def reconstruct_sequence(
    frames: Iterable, parameters: Parameters, device=None
) -> Iterator[SurfaceReconstruction]:
    """Reconstruct a sequence of frames (reconstruction.py:493-514 of the
    reference): a generator of resolved results, one per frame, in order.

    Frame t+1 is dispatched before frame t's mesh is resolved, so frame t's
    mesh copy (on a side stream, into pinned host memory) overlaps frame
    t+1's work. A warm dense frame (every plan of the frames before it in
    place) dispatches all of its device work without reading the card, so
    the card runs ahead of the host by up to a frame. Where a frame's plans
    missed, its resolve runs it again synchronously, with its original
    input. ``SPLASHSURF_TPU_PIPELINE=0`` runs frame at a time. Each frame
    goes through ``reconstruct_surface`` with ``device``.
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
