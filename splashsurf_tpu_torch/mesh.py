"""Mesh container and consistency check (PyTorch port of the corresponding
parts of ``splashsurf_tpu.mesh``). The mesh lives on the host as numpy
arrays; the checks are host-side numpy."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriMesh3d:
    """A triangle surface mesh: vertices (V, 3) float, triangles (T, 3) int32
    (``TriMesh3d``, mesh.rs:188-193)."""

    vertices: np.ndarray
    triangles: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])


def edge_information(triangles: np.ndarray):
    """Unique undirected edges (E, 2) and their incident-triangle counts
    (``compute_edge_information``, mesh.rs:955-1092)."""
    tris = np.asarray(triangles, dtype=np.int64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    e.sort(axis=1)
    edges, counts = np.unique(e, axis=0, return_counts=True)
    return edges, counts


def check_mesh_consistency(
    vertices,
    triangles,
    check_closedness: bool = True,
    check_manifoldness: bool = True,
    debug: bool = False,
    grid=None,
) -> Optional[str]:
    """Check that the mesh is closed and manifold (marching_cubes.rs:129-213).

    Returns None if consistent, else a human-readable error string: every
    edge must be shared by exactly two triangles, no triangle may be
    degenerate, and every vertex's triangle fan must be one cycle. With
    ``debug=True`` defective edges are located by midpoint (and MC cell, if
    ``grid`` is given).
    """
    tris = np.asarray(triangles)
    errors = []
    if tris.size:
        degenerate = (
            (tris[:, 0] == tris[:, 1])
            | (tris[:, 1] == tris[:, 2])
            | (tris[:, 2] == tris[:, 0])
        )
        if degenerate.any():
            errors.append(f"{int(degenerate.sum())} degenerate triangles")
        edges, counts = edge_information(tris)
        boundary = counts == 1
        nonmanifold = counts > 2
        if check_closedness and boundary.any():
            errors.append(f"{int(boundary.sum())} boundary (hole) edges")
            if debug:
                errors.append(
                    _locate_edges(vertices, edges[boundary][:8], grid, "hole")
                )
        if check_manifoldness and nonmanifold.any():
            errors.append(f"{int(nonmanifold.sum())} non-manifold edges")
            if debug:
                errors.append(
                    _locate_edges(
                        vertices, edges[nonmanifold][:8], grid, "non-manifold"
                    )
                )
        if check_manifoldness:
            nm_verts = _nonmanifold_vertices(tris, int(np.max(tris)) + 1)
            if nm_verts:
                errors.append(f"{nm_verts} non-manifold vertices")
    if errors:
        return "; ".join(errors)
    return None


def _locate_edges(vertices, edges, grid, label: str) -> str:
    """Describe defective edges by midpoint (and grid cell if available)."""
    verts = np.asarray(vertices)
    parts = []
    for a, b in edges:
        mid = 0.5 * (verts[a] + verts[b])
        loc = f"({mid[0]:.5g}, {mid[1]:.5g}, {mid[2]:.5g})"
        if grid is not None:
            cell = np.floor(
                (mid - np.asarray(grid.min)) / grid.cell_size
            ).astype(int)
            loc += f" cell {tuple(cell.tolist())}"
        parts.append(f"{label} edge v{a}-v{b} at {loc}")
    return "; ".join(parts)


def _nonmanifold_vertices(tris: np.ndarray, num_vertices: int) -> int:
    """Count vertices whose incident triangle fan is not a single cycle.

    Each triangle (a,b,c) contributes the directed link edges (v=a: b->c),
    (v=b: c->a), (v=c: a->b). A vertex is manifold iff its link edges form
    exactly one permutation cycle. Successors are found by binary search over
    packed (v, src) keys; cycles are counted by pointer-doubling
    min-propagation.
    """
    t = np.asarray(tris, dtype=np.int64)
    if len(t) == 0:
        return 0
    nv = int(num_vertices)
    V = np.concatenate([t[:, 0], t[:, 1], t[:, 2]])
    S = np.concatenate([t[:, 1], t[:, 2], t[:, 0]])
    D = np.concatenate([t[:, 2], t[:, 0], t[:, 1]])

    key_src = V * nv + S
    order = np.argsort(key_src, kind="stable")
    ks = key_src[order]
    bad = np.zeros(nv, bool)

    # duplicate (v, src): two fan triangles leave the same link vertex
    dup = ks[1:] == ks[:-1]
    bad[(ks[1:][dup]) // nv] = True

    # successor slot of (v, s)->(v, d) is the slot whose (v, src) == (v, d)
    key_dst = V * nv + D
    pos = np.searchsorted(ks, key_dst)
    pos_c = np.minimum(pos, len(ks) - 1)
    found = ks[pos_c] == key_dst
    bad[V[~found]] = True  # a target that is never a source: open/torn fan
    nxt = np.where(found, order[pos_c], np.arange(len(V)))

    # every link slot must also be entered exactly once (in-degree 1), or a
    # rho-shaped link (duplicate link target) escapes the cycle count
    indeg = np.zeros(len(V), np.int64)
    np.add.at(indeg, nxt[found], 1)
    bad[V[indeg != 1]] = True

    # pointer-doubling min-propagation: rep[i] = min slot in i's cycle
    rep = np.arange(len(V))
    hop = nxt.copy()
    for _ in range(int(np.ceil(np.log2(max(len(V), 2)))) + 1):
        rep = np.minimum(rep, rep[hop])
        hop = hop[hop]
    # one cycle per vertex <=> one distinct representative per vertex
    reps_per_v = np.zeros(nv, np.int64)
    is_rep = rep == np.arange(len(V))
    np.add.at(reps_per_v, V[is_rep], 1)
    has_link = np.zeros(nv, bool)
    has_link[V] = True
    bad |= has_link & (reps_per_v != 1)
    return int(np.count_nonzero(bad))
