"""splashsurf_tpu_torch: PyTorch + CUDA port of ``splashsurf_tpu``.

Surface reconstruction of SPH particle data on an NVIDIA GPU: particle
positions plus particle radius, kernel support radius and marching cubes
cell size in, a closed triangle mesh out. The dense global route of the
reference package is ported; its two TPU kernels are hand-written CUDA for
Hopper (``csrc/``), each beside a plain PyTorch version that runs on the
CPU. This package imports neither ``jax`` nor ``splashsurf_tpu``.
"""

from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mc.dense import marching_cubes
from splashsurf_tpu_torch.mesh import TriMesh3d, check_mesh_consistency
from splashsurf_tpu_torch.params import (
    GridDecompositionParameters,
    Parameters,
    SpatialDecomposition,
)
from splashsurf_tpu_torch.reconstruction import (
    SurfaceReconstruction,
    grid_for_reconstruction,
    reconstruct_surface,
)
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

__all__ = [
    "Aabb3d",
    "GridDecompositionParameters",
    "Parameters",
    "SpatialDecomposition",
    "SurfaceReconstruction",
    "TriMesh3d",
    "UniformGrid",
    "check_mesh_consistency",
    "grid_for_reconstruction",
    "kernel_extents",
    "marching_cubes",
    "reconstruct_surface",
]
