"""Marching cubes: generated case tables + vectorized triangulation."""

from splashsurf_tpu_torch.mc.lut import (
    EDGE_AXIS,
    EDGE_BASE_OFFSET,
    NUM_EDGES,
    TRI_COUNT,
    TRI_TABLE,
)
from splashsurf_tpu_torch.mc.dense import marching_cubes

__all__ = [
    "TRI_TABLE",
    "TRI_COUNT",
    "EDGE_AXIS",
    "EDGE_BASE_OFFSET",
    "NUM_EDGES",
    "marching_cubes",
]
