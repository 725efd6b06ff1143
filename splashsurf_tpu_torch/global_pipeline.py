"""Global (single dense grid) reconstruction pipeline (PyTorch port of
``splashsurf_tpu.global_pipeline``): densities -> particle weights m / rho
-> level set on the full background grid -> marching cubes
(reconstruction.rs:65-194).

A frame runs on the speculative plans of the frames before it, as the
reference's does: the density plan (``neighbors._DENSITY_PLAN``), the
background grid (``reconstruction._GRID_PLAN``, checked through
``grid_check``), and the dense route's overflow, MC and pull plans
(``ops.global_sweep``). Their checks come back with the mesh; the outcomes
are counted in ``SPECULATION_STATS`` under the reference's keys.

The cell-raster densities (``_cellrast_frame``) skip the density stage: rho
comes from a pair sweep (kernel K4) over the fraction rasters that the level
set builds anyway. They are off by default, as in the reference, and turned
on by ``SPLASHSURF_TPU_DENSITY_CELLRASTER``, read per call: "1" for CUDA
tensors, "1cpu" for CPU tensors too. As in the reference
(global_pipeline.py:383-389), a frame takes them when the switch is on, the
previous frame of the same (grid, N) left no raster overflow (its overflow
plan is 0) and the MC capacities of its grid are planned; a frame whose own
raster overflows then runs again with the legacy densities.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch import kernels, neighbors
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.ops import global_sweep as gs
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.reconstruction import GridPlanMiss, SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# Frame speculation outcomes (the reference's counters,
# global_pipeline.py:26-32); tests reset them freely.
SPECULATION_STATS = {
    "frames": 0,
    "density_miss": 0,
    "grid_miss": 0,
    "caps_retry": 0,
    "overflow_retry": 0,
}


def compute_densities(positions: torch.Tensor, parameters: Parameters) -> torch.Tensor:
    """Per-particle SPH densities on the positions' device
    (``neighbors.compute_particle_densities``)."""
    return neighbors.compute_particle_densities(
        positions, parameters.compact_support_radius, parameters.particle_rest_mass
    )


def use_cellraster(device: torch.device) -> bool:
    """Whether ``SPLASHSURF_TPU_DENSITY_CELLRASTER`` turns the cell-raster
    densities on for tensors on ``device``."""
    env = os.environ.get("SPLASHSURF_TPU_DENSITY_CELLRASTER", "0")
    return env != "0" and (device.type == "cuda" or env == "1cpu")


def _cellrast_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid,
                    hsc: int, grid_check, defer_pull: bool):
    """The dense frame with cell-raster densities (reference
    global_pipeline.py:219-316): (pull, rho), or None when a particle
    overflowed its cell's raster slots; the overflow plan has then grown,
    and the caller runs the legacy densities. A deferred pull reports an
    overflow as a redo."""
    h = parameters.compact_support_radius
    fracs, n_over, meta = gs.rasterize_global(positions, None, grid, 2, hsc, 0, with_meta=True)
    reach = int(math.ceil(h / grid.cell_size - 1e-9))
    fv, rho = gs.density_weights_from_rasters(
        *fracs, *meta, parameters.particle_rest_mass, h, grid, hsc, reach,
        h / grid.cell_size,
    )
    neighbors.LAST_GATE.clear()
    neighbors.LAST_GATE.update(kind="cellraster", n=positions.shape[0])
    none = positions.new_empty(0)
    ls = gs.sweep_global(fracs + (fv,), (none,) * 4, grid, h, hsc)
    del fracs, fv
    okey = (grid.n_points, positions.shape[0])
    checks = (grid_check,) if grid_check is not None else ()
    try:
        out = gs._finish_global_dense(
            ls, grid, parameters.iso_surface_threshold, okey, 0, n_over,
            checks, defer_pull, ("grid",) * len(checks),
        )
    except gs.SpeculationMiss as e:
        SPECULATION_STATS["grid_miss"] += 1
        raise GridPlanMiss(str(e)) from e
    if out is None:
        # later frames go legacy until a frame fits the plan to 0 again
        SPECULATION_STATS["overflow_retry"] += 1
        gs._OVER_PLAN[okey] = gs._pow2(gs._LAST_OVERFLOW[0] * 2, lo=4096)
        return None
    return out, rho


def _legacy_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid,
                  hsc: int, grid_check, defer_pull: bool):
    """The dense frame with the density stage (reference
    global_pipeline.py:425-490): (pull, rho). The densities run on their
    plan; a density miss clears it and runs the frame again, a grid miss
    raises GridPlanMiss."""
    h = parameters.compact_support_radius
    for _ in range(2):
        rho, check = neighbors.compute_particle_densities(
            positions, h, parameters.particle_rest_mass, speculate=True
        )
        values = kernels.rounded(parameters.particle_rest_mass, rho.dtype) / rho
        pairs = [("density", check), ("grid", grid_check)]
        labels = tuple(name for name, c in pairs if c is not None)
        checks = tuple(c for _, c in pairs if c is not None)
        try:
            out = gs.reconstruct_global_dense(
                positions, values, grid, h, hsc, parameters.iso_surface_threshold,
                deferred_checks=checks, defer_pull=defer_pull, check_labels=labels,
            )
            if not defer_pull:
                verts, tris = out
                out = gs.PendingPull(lambda: ("ok", verts, tris), [])
            return out, rho
        except gs.SpeculationMiss as e:
            failed = {labels[i] for i, ok in enumerate(e.flags) if not ok}
            if "grid" in failed:
                SPECULATION_STATS["grid_miss"] += 1
                raise GridPlanMiss(str(e)) from e
            SPECULATION_STATS["density_miss"] += 1
            neighbors.clear_density_plan()
    raise RuntimeError(
        "the density plan missed twice in a row; the second frame plans from "
        "scratch, so a plan was not invalidated"
    )


def reconstruct_surface_global(
    positions: torch.Tensor,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    grid_check=None,
    n_valid: Optional[int] = None,
    defer_pull: bool = False,
) -> SurfaceReconstruction:
    """Reconstruct on one dense grid on the positions' device. The mesh comes
    back to the host (with ``defer_pull``, at ``resolve()``); the
    per-particle densities stay a device tensor; the neighbour lists, when
    ``parameters.global_neighborhood_list`` asks for them, are searched
    after the mesh is dispatched and come back with the result.

    ``grid_check`` is a device bool that says whether a speculated ``grid``
    still holds (``reconstruction._grid_check_device``); it comes back with
    the mesh, and a False one raises ``reconstruction.GridPlanMiss`` (with
    ``defer_pull``, ``resolve()`` runs the frame again). Only the first
    ``n_valid`` rows of ``positions`` are particles, where that is given;
    the densities of the rest are 0."""
    full, n = positions, positions.shape[0]
    if n_valid is not None:
        positions = positions[: int(n_valid)]
    hsc = kernel_extents(parameters.compact_support_radius, grid.cell_size).half_supported_cells
    SPECULATION_STATS["frames"] += 1
    defer_pull = defer_pull and not parameters.global_neighborhood_list
    out = None
    if (
        use_cellraster(positions.device)
        and gs._OVER_PLAN.get((grid.n_points, positions.shape[0])) == 0
        and (grid.n_points, str(positions.dtype)) in gs._MC_CAPS
    ):
        out = _cellrast_frame(positions, parameters, grid, hsc, grid_check, defer_pull)
    if out is None:
        out = _legacy_frame(positions, parameters, grid, hsc, grid_check, defer_pull)
    pull, rho = out
    rho = torch.cat([rho, rho.new_zeros(n - rho.shape[0])]) if rho.shape[0] < n else rho
    rec = SurfaceReconstruction(
        grid=grid, mesh=None, particle_densities=rho,
        particle_neighbors=neighbors.particle_neighbor_lists(positions, parameters),
        particle_inside_aabb=particle_inside_aabb,
    )
    redo = functools.partial(
        reconstruct_surface_global, full, parameters, grid, particle_inside_aabb,
        n_valid=n_valid,
    )
    rec._pending_mesh = DeferredMesh(rec, pull, lambda code: redo())
    return rec if defer_pull else rec.resolve()


class DeferredMesh:
    """The pending mesh of a dense frame, resolved once
    (``SurfaceReconstruction.resolve``): the ``PendingPull``'s mesh, or,
    where it reports a redo, the mesh of ``redo(code)``, a synchronous run
    of the frame, whose grid and densities then replace the frame's
    (the reference's ``_resolve_mesh``, reconstruction.py:465-490)."""

    def __init__(self, rec: SurfaceReconstruction, pull, redo):
        self.rec, self.pull, self.redo = rec, pull, redo

    def __call__(self) -> TriMesh3d:
        out = self.pull.resolve()
        if out[0] == "ok":
            return TriMesh3d(vertices=out[1].numpy(), triangles=out[2].numpy())
        again = self.redo(out[0])
        self.rec.grid = again.grid
        self.rec.particle_densities = again.particle_densities
        return again.mesh
