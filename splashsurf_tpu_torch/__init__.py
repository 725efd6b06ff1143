"""splashsurf_tpu_torch: PyTorch + CUDA port of ``splashsurf_tpu``.

Surface reconstruction of SPH particle data on an NVIDIA GPU: particle
positions plus particle radius, kernel support radius and marching cubes
cell size in, a closed triangle mesh out, one frame at a time
(``reconstruct_surface``) or over a sequence (``reconstruct_sequence``), and
through the post-processing recipe of the reference's CLI
(``reconstruction_pipeline``; ``python -m splashsurf_tpu_torch reconstruct``,
with file IO in ``io``). The dense global route (with the legacy or the
cell-raster densities), the x-slab route past the dense gate and the
subdomain-grid route of the reference package, resident or streamed, are
ported, the subdomain route also sharded over several devices or virtual
shards of one (``parallel``), and so is its neighbour search
(``neighborhood_search_spatial_hashing_parallel``); their four TPU kernels
are hand-written CUDA for Hopper (``csrc/``), each beside a plain PyTorch
version that runs on the CPU. The top-level names are the reference's
pysplashsurf-parity surface (pysplashsurf/src/lib.rs:29-79), and its
submodules load on first access. Inputs run on the card unless the caller
asks for the CPU. This package imports neither ``jax`` nor
``splashsurf_tpu``.
"""

import importlib

from splashsurf_tpu_torch import io, kernels
from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.cli import run_splashsurf
from splashsurf_tpu_torch.mc.dense import marching_cubes
from splashsurf_tpu_torch.mesh import (
    MeshAttribute,
    MeshType,
    MeshWithData,
    MixedTriQuadMesh3d,
    TriMesh3d,
    VertexVertexConnectivity,
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
from splashsurf_tpu_torch.postprocess import (
    convert_tris_to_quads,
    decimation_with_data,
    marching_cubes_cleanup,
    marching_cubes_cleanup_with_data,
)
from splashsurf_tpu_torch.postprocess import decimation as barnacle_decimation
from splashsurf_tpu_torch.postprocess import laplacian_smoothing as laplacian_smoothing_parallel
from splashsurf_tpu_torch.postprocess import (
    laplacian_smoothing_normals as laplacian_smoothing_normals_parallel,
)
from splashsurf_tpu_torch.reconstruction import (
    SurfaceReconstruction,
    grid_for_reconstruction,
    reconstruct_sequence,
    reconstruct_surface,
)
from splashsurf_tpu_torch.sph_interpolation import SphInterpolator
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# submodules loaded on first access, as the reference's
_SUBMODULES = (
    "io", "mesh", "profiling", "postprocess", "pipeline", "mc", "neighbors", "density",
    "subdomains", "sph_interpolation", "sequence", "parallel", "cli", "studio",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"splashsurf_tpu_torch.{name}")
    raise AttributeError(f"module 'splashsurf_tpu_torch' has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "Aabb3d",
    "GridDecompositionParameters",
    "MeshAttribute",
    "MeshType",
    "MeshWithData",
    "MixedTriQuadMesh3d",
    "NeighborhoodLists",
    "NeighborhoodStats",
    "Parameters",
    "PostprocessingParameters",
    "ReconstructionResult",
    "SpatialDecomposition",
    "SphInterpolator",
    "SurfaceReconstruction",
    "TriMesh3d",
    "UniformGrid",
    "VertexVertexConnectivity",
    "barnacle_decimation",
    "check_mesh_consistency",
    "compute_neighborhood_stats",
    "convert_tris_to_quads",
    "decimation_with_data",
    "grid_for_reconstruction",
    "io",
    "kernel_extents",
    "kernels",
    "laplacian_smoothing_normals_parallel",
    "laplacian_smoothing_parallel",
    "marching_cubes",
    "marching_cubes_cleanup",
    "marching_cubes_cleanup_with_data",
    "neighborhood_search_spatial_hashing_parallel",
    "reconstruct_sequence",
    "reconstruct_surface",
    "reconstruction_pipeline",
    "run_splashsurf",
]
