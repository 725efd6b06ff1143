"""Raw XYZ particle format: consecutive little-endian f32 triplets
(reference: io/xyz_format.rs)."""

from __future__ import annotations

import numpy as np


def particles_from_xyz(path: str, dtype=np.float32) -> np.ndarray:
    data = np.fromfile(path, dtype="<f4")
    if data.size % 3 != 0:
        raise ValueError(f"xyz file size not a multiple of 12 bytes: {path}")
    return data.reshape(-1, 3).astype(dtype)


def write_particles_xyz(path: str, positions: np.ndarray) -> None:
    np.ascontiguousarray(positions, dtype="<f4").tofile(path)
