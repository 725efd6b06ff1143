"""Global (single dense grid) reconstruction pipeline (PyTorch port of
``splashsurf_tpu.global_pipeline``): densities -> particle weights m / rho
-> level set on the full background grid -> marching cubes
(reconstruction.rs:65-194).

The cell-raster densities (``_cellrast_frame``) skip the density stage: rho
comes from a pair sweep (kernel K4) over the fraction rasters that the level
set builds anyway. They are off by default, as in the reference, and turned
on by ``SPLASHSURF_TPU_DENSITY_CELLRASTER``, read per call: "1" for CUDA
tensors, "1cpu" for CPU tensors too. A frame takes them when the switch is
on and its own raster has no slot overflow (the exact count, read back
once); otherwise it runs the legacy densities and the normal raster. The
reference also requires that the previous frame of the same (grid, N) had
no overflow, because its overflow capacity is a static plan; the port keeps
no plans, and both rules give the same mesh within the tolerances of the
two density formulations.
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
from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents



def compute_densities(positions: torch.Tensor, parameters: Parameters) -> torch.Tensor:
    """Per-particle SPH densities on the positions' device
    (``neighbors.compute_particle_densities``)."""
    return neighbors.compute_particle_densities(
        positions, parameters.compact_support_radius, parameters.particle_rest_mass
    )

def use_cellraster(device: torch.device) -> bool:
    """Whether ``SPLASHSURF_TPU_DENSITY_CELLRASTER`` turns the cell-raster
    densities on for tensors on ``device`` (global_pipeline.py:383-389 of
    the reference)."""
    env = os.environ.get("SPLASHSURF_TPU_DENSITY_CELLRASTER", "0")
    return env != "0" and (device.type == "cuda" or env == "1cpu")


def _cellrast_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid, hsc: int):
    """The dense frame with cell-raster densities: (vertices, triangles,
    rho) as device tensors, or None when a particle overflowed its cell's
    raster slots (the caller then runs the legacy densities)."""
    h = parameters.compact_support_radius
    fracs, n_over, meta = gs.rasterize_global(positions, None, grid, 2, hsc, with_meta=True)
    if n_over:
        return None
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
    verts, tris = gs.mesh_from_level_set(ls, grid, parameters.iso_surface_threshold)
    return verts, tris, rho


def reconstruct_surface_global(
    positions: torch.Tensor,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    defer_pull: bool = False,
) -> SurfaceReconstruction:
    """Reconstruct on one dense grid on the positions' device. The mesh comes
    back to the host (with ``defer_pull``, at ``resolve()``); the
    per-particle densities stay a device tensor; the neighbour lists, when
    ``parameters.global_neighborhood_list`` asks for them, are searched
    after the mesh is dispatched and come back with the result."""
    h = parameters.compact_support_radius
    hsc = kernel_extents(h, grid.cell_size).half_supported_cells
    out = None
    if use_cellraster(positions.device):
        out = _cellrast_frame(positions, parameters, grid, hsc)
    if out is not None:
        verts, tris, rho = out
    else:
        rho = neighbors.compute_particle_densities(positions, h, parameters.particle_rest_mass)
        values = kernels.rounded(parameters.particle_rest_mass, rho.dtype) / rho
        verts, tris = gs.reconstruct_global_dense(
            positions, values, grid, h, hsc, parameters.iso_surface_threshold
        )
    pull = MeshPull(verts, tris)
    rec = SurfaceReconstruction(
        grid=grid, mesh=None, particle_densities=rho,
        particle_neighbors=neighbors.particle_neighbor_lists(positions, parameters),
        particle_inside_aabb=particle_inside_aabb,
    )
    rec._pending_mesh = pull
    return rec if defer_pull else rec.resolve()


class MeshPull:
    """The copy of a device mesh to the host, started when it is made and
    finished by ``resolve()``, which returns the ``TriMesh3d``.

    For CUDA tensors the vertex and triangle copies run into pinned host
    buffers on a side stream, after the current stream's work up to now, so
    they overlap whatever the caller queues next on the current stream; the
    device tensors stay referenced, and recorded on the side stream, until
    the copy ends. For CPU tensors there is nothing to copy."""

    def __init__(self, verts: torch.Tensor, tris: torch.Tensor):
        self._dev = (verts, tris)
        self._event = None
        if verts.device.type != "cuda":
            self._host = (verts, tris)
            return
        stream = _copy_stream(verts.device)
        stream.wait_stream(torch.cuda.current_stream(verts.device))
        with torch.cuda.stream(stream):
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in (verts, tris)
            )
            for t in (verts, tris):
                t.record_stream(stream)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def resolve(self) -> TriMesh3d:
        if self._event is not None:
            self._event.synchronize()
        self._dev = None
        v, t = self._host
        return TriMesh3d(vertices=v.numpy(), triangles=t.numpy())


@functools.cache
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for the mesh copies."""
    return torch.cuda.Stream(device=device)
