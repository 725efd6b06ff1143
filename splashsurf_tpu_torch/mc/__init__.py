"""Marching cubes: generated case tables + vectorized triangulation."""

from splashsurf_tpu_torch.mc.lut import (
    EDGE_AXIS,
    EDGE_BASE_OFFSET,
    NUM_EDGES,
    TRI_COUNT,
    TRI_TABLE,
)
from splashsurf_tpu_torch.mc.dense import (
    MarchingCubesResult,
    decode_edge_flat,
    marching_cubes,
    marching_cubes_padded,
)

__all__ = [
    "TRI_TABLE",
    "TRI_COUNT",
    "EDGE_AXIS",
    "EDGE_BASE_OFFSET",
    "NUM_EDGES",
    "marching_cubes",
    "marching_cubes_padded",
    "MarchingCubesResult",
]
