"""Global (single dense grid) reconstruction pipeline (PyTorch port of the
default path of ``splashsurf_tpu.global_pipeline``): densities -> particle
weights m / rho -> level set on the full background grid -> marching cubes
(reconstruction.rs:65-194)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.neighbors import compute_particle_densities
from splashsurf_tpu_torch.ops.global_sweep import reconstruct_global_dense
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents


def reconstruct_surface_global(
    positions: torch.Tensor,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
) -> SurfaceReconstruction:
    """Reconstruct on one dense grid on the positions' device. The mesh comes
    back to the host; the per-particle densities stay a device tensor."""
    h = parameters.compact_support_radius
    hsc = kernel_extents(h, grid.cell_size).half_supported_cells
    rho = compute_particle_densities(positions, h, parameters.particle_rest_mass)
    values = kernels.rounded(parameters.particle_rest_mass, rho.dtype) / rho
    verts, tris = reconstruct_global_dense(
        positions, values, grid, h, hsc, parameters.iso_surface_threshold
    )
    return SurfaceReconstruction(
        grid=grid,
        mesh=TriMesh3d(vertices=verts.cpu().numpy(), triangles=tris.cpu().numpy()),
        particle_densities=rho,
        particle_inside_aabb=particle_inside_aabb,
    )
