"""Meshes built in code for the port's post-processing tests: a subdivided
icosahedron on the unit sphere, and the marching-cubes mesh of a sphere's
signed distance field."""

import numpy as np

import splashsurf_tpu_torch as pt


def icosphere(subdivisions: int = 2, dtype=np.float64):
    """A closed, manifold, outward-oriented triangle mesh of the unit
    sphere: an icosahedron whose faces are split in four ``subdivisions``
    times, the new vertices pushed onto the sphere."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return pt.TriMesh3d(np.asarray(verts, dtype), np.asarray(faces, np.int32))


def sphere_mc(n: int = 25, dtype=np.float64):
    """The marching-cubes mesh of the unit sphere's SDF on an n^3 lattice
    over [-1.5, 1.5]^3, with vertices in ``dtype``."""
    coords = np.linspace(-1.5, 1.5, n)
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    values = 1.0 - np.sqrt(X**2 + Y**2 + Z**2)
    mesh = pt.marching_cubes(values.astype(np.float32), 0.0, coords[1] - coords[0], (-1.5,) * 3,
                             device="cpu")
    return pt.TriMesh3d(np.asarray(mesh.vertices, dtype), np.asarray(mesh.triangles, np.int32))
