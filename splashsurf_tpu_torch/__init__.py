"""splashsurf_tpu_torch: PyTorch + CUDA port of ``splashsurf_tpu``.

Surface reconstruction of SPH particle data on an NVIDIA GPU: particle
positions plus particle radius, kernel support radius and marching cubes
cell size in, a closed triangle mesh out, one frame at a time
(``reconstruct_surface``) or over a sequence (``reconstruct_sequence``), and
through the post-processing recipe of the reference's CLI
(``reconstruction_pipeline``; ``python -m splashsurf_tpu_torch reconstruct``,
with file IO in ``io``). The dense global route (with the legacy or the
cell-raster densities), the x-slab route past the dense gate and the
subdomain-grid route of the reference package are ported, and so is its
neighbour search (``neighborhood_search_spatial_hashing_parallel``); their four TPU kernels are hand-written CUDA for Hopper
(``csrc/``), each beside a plain PyTorch version that runs on the CPU. Inputs
run on the card unless the caller asks for the CPU. This package imports
neither ``jax`` nor ``splashsurf_tpu``.
"""

from splashsurf_tpu_torch import io
from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mc.dense import marching_cubes
from splashsurf_tpu_torch.mesh import (
    MeshAttribute,
    MeshWithData,
    MixedTriQuadMesh3d,
    TriMesh3d,
    check_mesh_consistency,
)
from splashsurf_tpu_torch.neighbors import (
    NeighborhoodLists,
    NeighborhoodStats,
    compute_neighborhood_stats,
    neighborhood_search_spatial_hashing_parallel,
)
from splashsurf_tpu_torch.params import (
    GridDecompositionParameters,
    Parameters,
    SpatialDecomposition,
)
from splashsurf_tpu_torch.pipeline import (
    PostprocessingParameters,
    ReconstructionResult,
    reconstruction_pipeline,
)
from splashsurf_tpu_torch.reconstruction import (
    SurfaceReconstruction,
    grid_for_reconstruction,
    reconstruct_sequence,
    reconstruct_surface,
)
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

__all__ = [
    "Aabb3d",
    "GridDecompositionParameters",
    "MeshAttribute",
    "MeshWithData",
    "MixedTriQuadMesh3d",
    "NeighborhoodLists",
    "NeighborhoodStats",
    "Parameters",
    "PostprocessingParameters",
    "ReconstructionResult",
    "SpatialDecomposition",
    "SurfaceReconstruction",
    "TriMesh3d",
    "UniformGrid",
    "check_mesh_consistency",
    "compute_neighborhood_stats",
    "grid_for_reconstruction",
    "io",
    "kernel_extents",
    "marching_cubes",
    "neighborhood_search_spatial_hashing_parallel",
    "reconstruct_sequence",
    "reconstruct_surface",
    "reconstruction_pipeline",
]
