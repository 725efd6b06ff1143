"""Wavefront OBJ mesh IO (reference: io/obj_format.rs)."""

from __future__ import annotations

import numpy as np


def mesh_from_obj(path: str):
    from splashsurf_tpu_torch.mesh import TriMesh3d

    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                ids = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(ids) - 1):  # fan-triangulate polygons
                    faces.append([ids[0], ids[i], ids[i + 1]])
    return TriMesh3d(
        vertices=np.asarray(verts, dtype=np.float32),
        triangles=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def write_mesh_obj(path: str, mesh, point_attributes=None) -> None:
    verts = np.asarray(mesh.vertices)
    normals = None
    if point_attributes:
        for name, data in point_attributes.items():
            if name.lower() in ("normals", "normal") and np.ndim(data) == 2:
                normals = np.asarray(data)
    with open(path, "w") as f:
        f.write("# splashsurf_tpu_torch surface mesh\n")
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        tris = np.asarray(mesh.triangles) + 1
        if normals is not None:
            for t in tris:
                f.write(f"f {t[0]}//{t[0]} {t[1]}//{t[1]} {t[2]}//{t[2]}\n")
        else:
            for t in tris:
                f.write(f"f {t[0]} {t[1]} {t[2]}\n")
        quads = getattr(mesh, "quads", None)
        if quads is not None:
            for q in np.asarray(quads) + 1:
                f.write(f"f {q[0]} {q[1]} {q[2]} {q[3]}\n")
