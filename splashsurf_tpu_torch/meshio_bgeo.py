"""meshio plugin for BGEO particle files (copy of ``splashsurf_tpu.meshio_bgeo``
over the port's ``io.bgeo``).

Analog of the reference's pure-Python meshio reader plugin
(pysplashsurf/pysplashsurf/bgeo.py:1-115): registers BGEO as a meshio format
when meshio is available; otherwise the reader is still usable directly.
"""

from __future__ import annotations

import numpy as np

from splashsurf_tpu_torch.io import bgeo as bgeo_io


def read_bgeo(filename):
    """Read a BGEO file into a meshio.Mesh (points + vertex cells)."""
    import meshio

    positions, attributes = bgeo_io.particles_from_bgeo(filename)
    n = len(positions)
    cells = [("vertex", np.arange(n, dtype=np.int64).reshape(n, 1))]
    return meshio.Mesh(
        points=positions.astype(np.float64),
        cells=cells,
        point_data={k: np.asarray(v) for k, v in attributes.items()},
    )


def write_bgeo(filename, mesh):
    """Write a meshio.Mesh's points (+ point_data) as BGEO."""
    bgeo_io.write_particles_bgeo(
        filename, np.asarray(mesh.points, dtype=np.float32), dict(mesh.point_data)
    )


def register() -> bool:
    """Register the BGEO reader/writer with meshio, if installed."""
    try:
        from meshio._helpers import register_format
    except Exception:
        return False
    register_format("bgeo", [".bgeo"], read_bgeo, {"bgeo": write_bgeo})
    return True


# Registering at import is harmless when meshio is absent.
_REGISTERED = register()
