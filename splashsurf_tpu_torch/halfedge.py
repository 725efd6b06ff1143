"""Half-edge style editable triangle mesh (host-side; a copy of the pure
numpy ``splashsurf_tpu.halfedge``).

Substrate for collapse-based decimation (reference:
splashsurf_lib/src/halfedge_mesh.rs:19-590). Topological edits are
inherently sequential, so this runs on host over numpy arrays + adjacency
sets; the batched mesh ops stay on device. The public surface mirrors the
reference: one-ring queries, legality-checked half-edge collapses, and
``into_parts(keep_vertices)`` to convert back with a vertex map.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np


class IllegalCollapse(Exception):
    pass


class HalfEdgeTriMesh:
    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        self.vertices = np.array(vertices, dtype=np.float64, copy=True)
        self.triangles = np.array(triangles, dtype=np.int64, copy=True)
        nv, nt = len(self.vertices), len(self.triangles)
        self.tri_valid = np.ones(nt, dtype=bool)
        self.vert_valid = np.ones(nv, dtype=bool)
        self.adj: List[Set[int]] = [set() for _ in range(nv)]
        self.v_tris: List[Set[int]] = [set() for _ in range(nv)]
        for t, (a, b, c) in enumerate(self.triangles):
            self.adj[a].update((b, c))
            self.adj[b].update((a, c))
            self.adj[c].update((a, b))
            self.v_tris[a].add(t)
            self.v_tris[b].add(t)
            self.v_tris[c].add(t)
        # per-vertex merge history for attribute mapping (into_parts)
        self.merged_from: List[List[int]] = [[v] for v in range(nv)]

    # -- queries -----------------------------------------------------------

    def is_valid_vertex(self, v: int) -> bool:
        return bool(self.vert_valid[v]) and len(self.adj[v]) > 0

    def is_valid_triangle(self, t: int) -> bool:
        return bool(self.tri_valid[t])

    def vertex_one_ring(self, v: int):
        return iter(self.adj[v])

    def vertex_one_ring_len(self, v: int) -> int:
        return len(self.adj[v])

    def has_edge(self, a: int, b: int) -> bool:
        return b in self.adj[a]

    def num_valid_triangles(self) -> int:
        return int(self.tri_valid.sum())

    # -- collapse ---------------------------------------------------------

    def is_collapse_ok(self, v_from: int, v_to: int) -> Optional[str]:
        """Legality of collapsing ``v_from`` into ``v_to`` (halfedge_mesh.rs
        ``is_collapse_ok``). Returns None if legal, else a reason string."""
        if not (self.is_valid_vertex(v_from) and self.is_valid_vertex(v_to)):
            return "invalid vertex"
        if v_to not in self.adj[v_from]:
            return "missing edge"
        shared_tris = self.v_tris[v_from] & self.v_tris[v_to]
        if len(shared_tris) != 2:
            return "boundary or non-manifold edge"
        opposite = set()
        for t in shared_tris:
            for v in self.triangles[t]:
                if v != v_from and v != v_to:
                    opposite.add(int(v))
        common = self.adj[v_from] & self.adj[v_to]
        if common != opposite:
            # The one-rings intersect beyond the shared faces: collapsing
            # would create a non-manifold fin (IntersectionOfOneRing).
            return "intersection of one-ring"
        if len(self.adj[v_from]) <= 3 and len(self.adj[v_to]) <= 3:
            return "would collapse tetrahedron"
        return None

    def try_collapse(self, v_from: int, v_to: int) -> None:
        """Collapse ``v_from`` into ``v_to``; raises IllegalCollapse if not ok."""
        reason = self.is_collapse_ok(v_from, v_to)
        if reason is not None:
            raise IllegalCollapse(reason)

        shared_tris = self.v_tris[v_from] & self.v_tris[v_to]
        for t in shared_tris:
            self.tri_valid[t] = False
            for v in self.triangles[t]:
                self.v_tris[int(v)].discard(t)

        for t in list(self.v_tris[v_from]):
            tri = self.triangles[t]
            self.triangles[t] = np.where(tri == v_from, v_to, tri)
            self.v_tris[v_to].add(t)
        self.v_tris[v_from].clear()

        for n in self.adj[v_from]:
            self.adj[n].discard(v_from)
            if n != v_to:
                self.adj[n].add(v_to)
                self.adj[v_to].add(n)
        self.adj[v_to].discard(v_to)
        self.adj[v_from].clear()
        self.vert_valid[v_from] = False
        self.merged_from[v_to].extend(self.merged_from[v_from])
        self.merged_from[v_from] = []

    # -- conversion ---------------------------------------------------------

    def into_parts(self, keep_vertices: bool = False, return_tri_map: bool = False):
        """Return (TriMesh3d, vertex_map[, tri_map]).

        ``vertex_map[i]`` lists the original vertex indices merged into the
        i-th output vertex (for attribute remapping). With ``keep_vertices``
        the vertex array is left unchanged (invalid vertices stay). With
        ``return_tri_map``, also return the original triangle index of each
        surviving output triangle (for cell-attribute remapping).
        """
        from splashsurf_tpu_torch.mesh import TriMesh3d

        tris = self.triangles[self.tri_valid]
        tri_map = np.nonzero(self.tri_valid)[0]
        if keep_vertices:
            mesh = TriMesh3d(
                vertices=self.vertices.astype(np.float32),
                triangles=tris.astype(np.int32),
            )
            vertex_map = [list(m) for m in self.merged_from]
        else:
            used = np.zeros(len(self.vertices), dtype=bool)
            if len(tris):
                used[tris.ravel()] = True
            new_index = np.cumsum(used) - 1
            mesh = TriMesh3d(
                vertices=self.vertices[used].astype(np.float32),
                triangles=new_index[tris].astype(np.int32),
            )
            vertex_map = [list(self.merged_from[v]) for v in np.nonzero(used)[0]]
        if return_tri_map:
            return mesh, vertex_map, tri_map
        return mesh, vertex_map
