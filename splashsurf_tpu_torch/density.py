"""Static stencil offset tables of the density splat (port of the tables in
``splashsurf_tpu.density``)."""

from __future__ import annotations

import numpy as np


def supported_point_offsets(hsc: int) -> np.ndarray:
    """Offsets from a particle's cell to all potentially supported points:
    (2*hsc+2)^3 point offsets in [-hsc, hsc+1]^3 (density_map.rs:649-663)."""
    rng = np.arange(-hsc, hsc + 2, dtype=np.int32)
    oi, oj, ok = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack([oi, oj, ok], axis=-1).reshape(-1, 3)


def gather_cell_offsets(hsc: int) -> np.ndarray:
    """Offsets from a grid point's base cell to the cells that can hold
    contributing particles, pruned to the support sphere: keep an offset o
    when the per-axis distance from the point to the cell interval [o, o+1]
    (in cube units) is below hsc (+ rounding slack)."""
    rng = np.arange(-(hsc + 1), hsc + 1, dtype=np.int32)
    oi, oj, ok = np.meshgrid(rng, rng, rng, indexing="ij")
    offs = np.stack([oi, oj, ok], axis=-1).reshape(-1, 3)
    d = np.where(offs > 0, offs, np.where(offs + 1 < 0, -(offs + 1), 0)).astype(
        np.float64
    )
    keep = (d**2).sum(axis=1) <= (hsc * (1.0 + 1e-3)) ** 2
    return offs[keep]
