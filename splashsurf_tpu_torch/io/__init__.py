"""Particle and mesh file IO (a copy of the pure numpy
``splashsurf_tpu.io``).

Pure-Python readers/writers for the formats the reference supports
(splashsurf_lib/src/io/): legacy VTK, XML VTU, BGEO (v5, gzip-aware), PLY,
OBJ, raw-f32 XYZ, and JSON particle lists. Format semantics follow the
reference README (README.md:258-312).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def particles_from_file(path: str, dtype=np.float32) -> np.ndarray:
    """Load particle positions (N, 3) from a file, dispatching on extension
    (reference: io.rs:17-43)."""
    positions, _ = particles_with_attributes_from_file(path, dtype=dtype)
    return positions


def particles_with_attributes_from_file(
    path: str, dtype=np.float32, attributes: Optional[list] = None
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    ext = _ext(path)
    if ext == "vtk":
        from splashsurf_tpu_torch.io import vtk

        return vtk.particles_from_vtk(path, dtype=dtype)
    elif ext == "vtu":
        from splashsurf_tpu_torch.io import vtk

        return vtk.particles_from_vtu(path, dtype=dtype)
    elif ext == "bgeo":
        from splashsurf_tpu_torch.io import bgeo

        return bgeo.particles_from_bgeo(path, dtype=dtype)
    elif ext == "ply":
        from splashsurf_tpu_torch.io import ply

        return ply.particles_from_ply(path, dtype=dtype)
    elif ext == "xyz":
        from splashsurf_tpu_torch.io import xyz

        return xyz.particles_from_xyz(path, dtype=dtype), {}
    elif ext == "json":
        from splashsurf_tpu_torch.io import json_format

        return json_format.particles_from_json(path, dtype=dtype), {}
    else:
        raise ValueError(f"unsupported particle file extension: .{ext} ({path})")


def write_particles(path: str, positions: np.ndarray, attributes=None) -> None:
    ext = _ext(path)
    if ext == "vtk":
        from splashsurf_tpu_torch.io import vtk

        vtk.write_particles_vtk(path, positions, attributes)
    elif ext == "bgeo":
        from splashsurf_tpu_torch.io import bgeo

        bgeo.write_particles_bgeo(path, positions, attributes)
    elif ext == "xyz":
        from splashsurf_tpu_torch.io import xyz

        xyz.write_particles_xyz(path, positions)
    elif ext == "json":
        from splashsurf_tpu_torch.io import json_format

        json_format.write_particles_json(path, positions)
    else:
        raise ValueError(f"unsupported particle output extension: .{ext} ({path})")


def write_mesh(path: str, mesh, point_attributes=None) -> None:
    """Write a mesh (TriMesh3d / MeshWithData) dispatching on extension."""
    from splashsurf_tpu_torch.mesh import MeshWithData

    if isinstance(mesh, MeshWithData):
        point_attributes = point_attributes or {
            a.name: a.data for a in mesh.point_attributes
        }
        mesh = mesh.mesh
    ext = _ext(path)
    if ext == "vtk":
        from splashsurf_tpu_torch.io import vtk

        vtk.write_mesh_vtk(path, mesh, point_attributes)
    elif ext == "vtu":
        from splashsurf_tpu_torch.io import vtk

        vtk.write_mesh_vtu(path, mesh, point_attributes)
    elif ext == "obj":
        from splashsurf_tpu_torch.io import obj

        obj.write_mesh_obj(path, mesh, point_attributes)
    elif ext == "ply":
        from splashsurf_tpu_torch.io import ply

        ply.write_mesh_ply(path, mesh, point_attributes)
    else:
        raise ValueError(f"unsupported mesh output extension: .{ext} ({path})")


def mesh_from_file(path: str):
    ext = _ext(path)
    if ext == "obj":
        from splashsurf_tpu_torch.io import obj

        return obj.mesh_from_obj(path)
    elif ext == "ply":
        from splashsurf_tpu_torch.io import ply

        return ply.mesh_from_ply(path)
    elif ext == "vtk":
        from splashsurf_tpu_torch.io import vtk

        return vtk.mesh_from_vtk(path)
    elif ext == "vtu":
        from splashsurf_tpu_torch.io import vtk

        return vtk.mesh_from_vtu(path)
    else:
        raise ValueError(f"unsupported mesh input extension: .{ext} ({path})")


def _ext(path: str) -> str:
    base = path[:-3] if path.endswith(".gz") else path
    return os.path.splitext(base)[1].lstrip(".").lower()
