"""JSON particle format: a single array of [x, y, z] triplets
(reference: io/json_format.rs)."""

from __future__ import annotations

import json

import numpy as np


def particles_from_json(path: str, dtype=np.float32) -> np.ndarray:
    with open(path) as f:
        data = json.load(f)
    arr = np.asarray(data, dtype=dtype)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"JSON particle file must be a list of [x,y,z]: {path}")
    return arr


def write_particles_json(path: str, positions: np.ndarray) -> None:
    with open(path, "w") as f:
        json.dump([[float(x), float(y), float(z)] for x, y, z in positions], f)
