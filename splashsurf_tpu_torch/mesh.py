"""Mesh containers and core mesh ops (PyTorch port of
``splashsurf_tpu.mesh``; reference: splashsurf_lib/src/mesh.rs).

The containers hold host numpy arrays. ``face_normals``, ``vertex_normals``
and ``triangle_areas`` run in torch: a tensor stays on its own device; an
array goes to ``device`` (default CUDA, RuntimeError without it) and the
result comes back as an array. Connectivity, the topology edits of
``MeshWithData`` and the consistency check are host numpy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Union

import numpy as np
import torch

from splashsurf_tpu_torch.placement import as_device_tensor


@dataclasses.dataclass
class TriMesh3d:
    """A triangle surface mesh: vertices (V, 3) float, triangles (T, 3) int32.

    Reference: ``TriMesh3d`` (mesh.rs:188-193).
    """

    vertices: np.ndarray
    triangles: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    # -- ops -------------------------------------------------------------

    def face_normals(self, normalized: bool = True, device=None):
        return face_normals(self.vertices, self.triangles, normalized=normalized, device=device)

    def vertex_normals(self, device=None):
        """Area-weighted vertex normals (mesh.rs:848-952)."""
        return vertex_normals(self.vertices, self.triangles, device=device)

    def nvertices(self) -> int:
        """pysplashsurf.pyi:70 parity."""
        return self.num_vertices

    def copy(self) -> "TriMesh3d":
        """Deep copy (pysplashsurf.pyi:263)."""
        return TriMesh3d(
            vertices=np.array(self.vertices),
            triangles=np.array(self.triangles),
        )

    def write_to_file(self, path, *, file_format=None) -> None:
        """Write the mesh to a file, format from the extension
        (pysplashsurf.pyi:275)."""
        from splashsurf_tpu_torch import io as _io

        _io.write_mesh(str(path), self)

    def par_vertex_normals(self, device=None):
        return self.vertex_normals(device=device)

    def vertex_normals_parallel(self, device=None):
        """pysplashsurf.pyi:267 name parity for :meth:`vertex_normals`."""
        return self.vertex_normals(device=device)

    def vertex_vertex_connectivity(self) -> "VertexVertexConnectivity":
        """Adjacent-vertex lists per vertex (mesh.rs:290).

        Returns a :class:`VertexVertexConnectivity` (a list of per-vertex
        neighbor arrays); use :func:`vertex_vertex_connectivity_csr` for
        the array program form.
        """
        offsets, neighbors = vertex_vertex_connectivity_csr(
            np.asarray(self.triangles), self.num_vertices
        )
        return VertexVertexConnectivity(
            neighbors[offsets[i] : offsets[i + 1]]
            for i in range(self.num_vertices)
        )

    def keep_vertices(self, vertex_mask: np.ndarray) -> "TriMesh3d":
        """Keep flagged vertices and all triangles whose vertices survive."""
        vertex_mask = np.asarray(vertex_mask, dtype=bool)
        new_index = np.cumsum(vertex_mask) - 1
        tris = np.asarray(self.triangles)
        tri_keep = vertex_mask[tris].all(axis=1)
        return TriMesh3d(
            vertices=np.asarray(self.vertices)[vertex_mask],
            triangles=new_index[tris[tri_keep]].astype(np.int32),
        )

    def keep_cells(self, cell_indices: np.ndarray) -> "TriMesh3d":
        """Keep the given triangles and drop unreferenced vertices (mesh.rs:269-372)."""
        tris = np.asarray(self.triangles)[np.asarray(cell_indices)]
        used = np.zeros(self.num_vertices, dtype=bool)
        used[tris.ravel()] = True
        new_index = np.cumsum(used) - 1
        return TriMesh3d(
            vertices=np.asarray(self.vertices)[used],
            triangles=new_index[tris].astype(np.int32),
        )

    def par_clamp_with_aabb(
        self, aabb, clamp_vertices: bool = True, keep_vertices: bool = False
    ) -> "TriMesh3d":
        """Remove cells fully outside the AABB, then clamp survivors (mesh.rs:333-371).

        Keeps every triangle with at least one vertex inside the AABB; drops
        unreferenced vertices unless ``keep_vertices``; when ``clamp_vertices``
        the surviving vertex positions are clamped into the AABB."""
        verts = np.asarray(self.vertices)
        lo = np.asarray(aabb.min, dtype=verts.dtype)
        hi = np.asarray(aabb.max, dtype=verts.dtype)
        inside = np.all((verts >= lo) & (verts <= hi), axis=1)
        tris = np.asarray(self.triangles)
        cells_to_keep = np.flatnonzero(inside[tris].any(axis=1))
        if keep_vertices:
            new = TriMesh3d(
                vertices=verts.copy(), triangles=tris[cells_to_keep].astype(np.int32)
            )
        else:
            new = self.keep_cells(cells_to_keep)
        if clamp_vertices:
            new = TriMesh3d(
                vertices=np.clip(np.asarray(new.vertices), lo, hi),
                triangles=new.triangles,
            )
        return new


@dataclasses.dataclass
class MixedTriQuadMesh3d:
    """Mesh with both triangle and quad cells (mesh.rs:232)."""

    vertices: np.ndarray
    triangles: np.ndarray  # (T, 3) int32
    quads: np.ndarray  # (Q, 4) int32

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def nvertices(self) -> int:
        """pysplashsurf.pyi:70 parity."""
        return self.num_vertices

    def copy(self) -> "MixedTriQuadMesh3d":
        return MixedTriQuadMesh3d(
            vertices=np.array(self.vertices),
            triangles=np.array(self.triangles),
            quads=np.array(self.quads),
        )

    def get_triangles(self) -> np.ndarray:
        """Copy of all triangle cells (pysplashsurf.pyi:156)."""
        return np.array(self.triangles, dtype=np.uint64)

    def get_quads(self) -> np.ndarray:
        """Copy of all quad cells (pysplashsurf.pyi:160)."""
        return np.array(self.quads, dtype=np.uint64)

    def write_to_file(self, path, *, file_format=None) -> None:
        from splashsurf_tpu_torch import io as _io

        _io.write_mesh(str(path), self)


@dataclasses.dataclass
class HexMesh3d:
    """Hexahedral cell mesh (mesh.rs:241), used for debug density output."""

    vertices: np.ndarray
    cells: np.ndarray  # (H, 8) int32

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])


@dataclasses.dataclass
class PointCloud3d:
    """Point cloud "mesh" (mesh.rs:250)."""

    vertices: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])


class VertexVertexConnectivity(list):
    """Vertex-vertex connectivity of a mesh (pysplashsurf.pyi:305 parity):
    a list of per-vertex neighbor index arrays with the reference's
    copy/take accessors."""

    def copy_connectivity(self) -> List[List[int]]:
        return [list(map(int, a)) for a in self]

    def take_connectivity(self) -> List[List[int]]:
        out = self.copy_connectivity()
        self.clear()
        return out


class MeshType(enum.Enum):
    """Type of mesh wrapped by a ``MeshWithData`` (pysplashsurf.pyi:318)."""

    Tri3d = "Tri3d"
    MixedTriQuad3d = "MixedTriQuad3d"


@dataclasses.dataclass
class MeshAttribute:
    """A named per-vertex (or per-cell) attribute (mesh.rs:162-184)."""

    name: str
    data: np.ndarray  # (V,) scalar or (V, 3) vector


@dataclasses.dataclass
class MeshWithData:
    """A mesh bundled with named point/cell attributes (mesh.rs:1227).

    The topology-editing operations remap BOTH point and cell attributes
    through the surviving vertex/cell index maps, like the reference's
    ``MeshWithData`` (mesh.rs:1227+)."""

    mesh: Union[TriMesh3d, MixedTriQuadMesh3d]
    point_attributes: List[MeshAttribute] = dataclasses.field(default_factory=list)
    cell_attributes: List[MeshAttribute] = dataclasses.field(default_factory=list)

    @property
    def mesh_type(self) -> MeshType:
        """pysplashsurf.pyi:80 parity."""
        return (
            MeshType.Tri3d
            if isinstance(self.mesh, TriMesh3d)
            else MeshType.MixedTriQuad3d
        )

    def _require_tri(self) -> "TriMesh3d":
        if not isinstance(self.mesh, TriMesh3d):
            raise TypeError(
                "attribute-remapping topology ops require a TriMesh3d"
            )
        return self.mesh

    def add_point_attribute(self, name: str, attribute) -> None:
        """Attach a point attribute (pysplashsurf.pyi:111): exactly one
        value per vertex."""
        data = np.asarray(attribute)
        if data.shape[0] != self.mesh.num_vertices:
            raise ValueError(
                f"point attribute {name!r} has {data.shape[0]} values for "
                f"{self.mesh.num_vertices} vertices"
            )
        self.point_attributes.append(MeshAttribute(name, data))

    def add_cell_attribute(self, name: str, attribute) -> None:
        """Attach a cell attribute (pysplashsurf.pyi:122): exactly one
        value per cell."""
        data = np.asarray(attribute)
        ncells = (
            len(self.mesh.triangles)
            if isinstance(self.mesh, TriMesh3d)
            else len(self.mesh.triangles) + len(self.mesh.quads)
        )
        if data.shape[0] != ncells:
            raise ValueError(
                f"cell attribute {name!r} has {data.shape[0]} values for "
                f"{ncells} cells"
            )
        self.cell_attributes.append(MeshAttribute(name, data))

    def copy_mesh(self):
        """Copy of the wrapped mesh without attributes (pysplashsurf.pyi:103)."""
        return self.mesh.copy()

    def copy(self) -> "MeshWithData":
        """Deep copy with data and attributes (pysplashsurf.pyi:107)."""
        return MeshWithData(
            mesh=self.mesh.copy(),
            point_attributes=[
                MeshAttribute(a.name, np.array(a.data))
                for a in self.point_attributes
            ],
            cell_attributes=[
                MeshAttribute(a.name, np.array(a.data))
                for a in self.cell_attributes
            ],
        )

    def write_to_file(self, path, *, file_format=None) -> None:
        """Write the mesh and its point attributes (pysplashsurf.pyi:133)."""
        from splashsurf_tpu_torch import io as _io

        _io.write_mesh(
            str(path),
            self.mesh,
            point_attributes={
                a.name: np.asarray(a.data) for a in self.point_attributes
            },
        )

    def keep_cells(self, cell_indices: np.ndarray) -> "MeshWithData":
        """Keep the given cells; point/cell attributes follow the maps."""
        mesh = self._require_tri()
        cell_indices = np.asarray(cell_indices)
        tris = np.asarray(mesh.triangles)[cell_indices]
        used = np.zeros(mesh.num_vertices, dtype=bool)
        used[tris.ravel()] = True
        return MeshWithData(
            mesh=mesh.keep_cells(cell_indices),
            point_attributes=[
                MeshAttribute(a.name, np.asarray(a.data)[used])
                for a in self.point_attributes
            ],
            cell_attributes=[
                MeshAttribute(a.name, np.asarray(a.data)[cell_indices])
                for a in self.cell_attributes
            ],
        )

    def keep_vertices(self, vertex_mask: np.ndarray) -> "MeshWithData":
        """Keep flagged vertices; cells with a dropped corner are removed and
        their cell attributes with them."""
        mesh = self._require_tri()
        vertex_mask = np.asarray(vertex_mask, dtype=bool)
        tri_keep = vertex_mask[np.asarray(mesh.triangles)].all(axis=1)
        return MeshWithData(
            mesh=mesh.keep_vertices(vertex_mask),
            point_attributes=[
                MeshAttribute(a.name, np.asarray(a.data)[vertex_mask])
                for a in self.point_attributes
            ],
            cell_attributes=[
                MeshAttribute(a.name, np.asarray(a.data)[tri_keep])
                for a in self.cell_attributes
            ],
        )

    def par_clamp_with_aabb(
        self, aabb, clamp_vertices: bool = True, keep_vertices: bool = False
    ) -> "MeshWithData":
        """Remove cells fully outside the AABB, clamp survivors, and remap
        attributes through the surviving cell/vertex maps (mesh.rs:333-371 +
        MeshWithData remapping). Defaults match ``TriMesh3d``."""
        mesh = self._require_tri()
        verts = np.asarray(mesh.vertices)
        lo = np.asarray(aabb.min, dtype=verts.dtype)
        hi = np.asarray(aabb.max, dtype=verts.dtype)
        inside = np.all((verts >= lo) & (verts <= hi), axis=1)
        tris = np.asarray(mesh.triangles)
        cells_to_keep = np.flatnonzero(inside[tris].any(axis=1))
        if keep_vertices:
            out = MeshWithData(
                mesh=TriMesh3d(
                    vertices=verts.copy(),
                    triangles=tris[cells_to_keep].astype(np.int32),
                ),
                point_attributes=self.point_attributes,
                cell_attributes=[
                    MeshAttribute(a.name, np.asarray(a.data)[cells_to_keep])
                    for a in self.cell_attributes
                ],
            )
        else:
            out = self.keep_cells(cells_to_keep)
        if clamp_vertices:
            out.mesh.vertices = np.clip(np.asarray(out.mesh.vertices), lo, hi)
        return out

    def remap_through_vertex_map(
        self, new_mesh: "TriMesh3d", vertex_map
    ) -> "MeshWithData":
        """Carry point attributes through a decimation/cleanup vertex map
        (``vertex_map[new_vertex] = old_vertex``, as returned by
        ``marching_cubes_cleanup`` / ``decimation``). Cell attributes cannot
        survive a collapse that changes the cell set and are dropped."""
        vm = np.asarray(vertex_map)
        return MeshWithData(
            mesh=new_mesh,
            point_attributes=[
                MeshAttribute(a.name, np.asarray(a.data)[vm])
                for a in self.point_attributes
            ],
            cell_attributes=[],
        )


# ---------------------------------------------------------------------------
# normals and areas (torch, on the given tensors' device)
# ---------------------------------------------------------------------------


def _torch_args(vertices, triangles, device):
    """(vertices, triangles, as_numpy): a tensor stays on its own device; an
    array goes to ``device`` (default CUDA), and the caller converts the
    result back."""
    as_numpy = not isinstance(vertices, torch.Tensor)
    v = as_device_tensor(vertices, device)
    t = triangles if isinstance(triangles, torch.Tensor) else torch.as_tensor(np.asarray(triangles))
    return v, t.to(device=v.device, dtype=torch.int64), as_numpy


def _unit(n: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0, norm, torch.ones_like(norm))


def _face_normals(v: torch.Tensor, t: torch.Tensor, normalized: bool) -> torch.Tensor:
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    return _unit(n) if normalized else n


def face_normals(vertices, triangles, normalized: bool = True, device=None):
    """Per-triangle normals: (T, 3)."""
    v, t, as_numpy = _torch_args(vertices, triangles, device)
    n = _face_normals(v, t, normalized)
    return n.cpu().numpy() if as_numpy else n


def vertex_normals(vertices, triangles, device=None):
    """Area-weighted vertex normals via scatter-add over triangle corners.

    The unnormalized cross product carries twice the triangle area, so summing
    it per incident vertex gives area weighting for free (mesh.rs:848-952).
    """
    v, t, as_numpy = _torch_args(vertices, triangles, device)
    fn = _face_normals(v, t, normalized=False)
    out = torch.zeros_like(v)
    for corner in range(3):
        out.index_add_(0, t[:, corner], fn)
    out = _unit(out)
    return out.cpu().numpy() if as_numpy else out


def triangle_areas(vertices, triangles, device=None):
    v, t, as_numpy = _torch_args(vertices, triangles, device)
    out = 0.5 * torch.linalg.vector_norm(_face_normals(v, t, normalized=False), dim=-1)
    return out.cpu().numpy() if as_numpy else out


# ---------------------------------------------------------------------------
# connectivity (host, numpy)
# ---------------------------------------------------------------------------


def vertex_vertex_connectivity_csr(triangles: np.ndarray, num_vertices: int):
    """CSR vertex adjacency from the triangle list (host, numpy).

    Returns (offsets (V+1,), neighbors (E,)) with duplicate edges removed.
    """
    tris = np.asarray(triangles, dtype=np.int64)
    # Each triangle contributes 6 directed edges.
    src = np.concatenate(
        [tris[:, 0], tris[:, 1], tris[:, 1], tris[:, 2], tris[:, 2], tris[:, 0]]
    )
    dst = np.concatenate(
        [tris[:, 1], tris[:, 0], tris[:, 2], tris[:, 1], tris[:, 0], tris[:, 2]]
    )
    key, _ = _unique_keys(src * num_vertices + dst)
    src_u = key // num_vertices
    dst_u = (key % num_vertices).astype(np.int32)
    counts = np.bincount(src_u, minlength=num_vertices)
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst_u


def vertex_cell_connectivity(triangles: np.ndarray, num_vertices: int):
    """Per-vertex incident triangle lists (mesh.rs vertex_cell_connectivity).

    Returns a ragged list of int arrays.
    """
    tris = np.asarray(triangles, dtype=np.int64)
    t_ids = np.repeat(np.arange(len(tris)), 3)
    v_ids = tris.ravel()
    order = np.argsort(v_ids, kind="stable")
    v_sorted, t_sorted = v_ids[order], t_ids[order]
    starts = np.searchsorted(v_sorted, np.arange(num_vertices))
    ends = np.searchsorted(v_sorted, np.arange(num_vertices) + 1)
    return [t_sorted[s:e] for s, e in zip(starts, ends)]


def density_map_to_hex_mesh(levelset: np.ndarray, grid, threshold: float):
    """Debug output, host numpy: one hexahedral cell per grid point above
    ``threshold`` (density_map.rs:741-827, ``sparse_density_map_to_hex_mesh``).

    Returns (vertices (V, 3) f32, hex cells (H, 8) int32, point values (H,)).
    """
    values = np.asarray(levelset)
    pts = np.argwhere(values > threshold)
    if len(pts) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 8), np.int32),
            np.zeros((0,), values.dtype),
        )
    mn = np.asarray(grid.min)
    cs = grid.cell_size
    corner_offsets = np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ]
    )
    corners = pts[:, None, :] + corner_offsets[None, :, :] - 0.5
    verts_all = (mn + corners * cs).reshape(-1, 3).astype(np.float32)
    keyed = corners.reshape(-1, 3)
    _, first, inverse = np.unique(
        keyed.view([("", keyed.dtype)] * 3), return_index=True, return_inverse=True
    )
    vertices = verts_all[first]
    cells = inverse.reshape(-1, 8).astype(np.int32)
    vals = values[pts[:, 0], pts[:, 1], pts[:, 2]]
    return vertices, cells, vals


def edge_information(triangles: np.ndarray):
    """Unique undirected edges (E, 2) and their incident-triangle counts
    (``compute_edge_information``, mesh.rs:955-1092)."""
    tris = np.asarray(triangles, dtype=np.int64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    e.sort(axis=1)
    n = int(e.max()) + 1 if e.size else 1
    keys, counts = _unique_keys(e[:, 0] * n + e[:, 1])
    return np.stack([keys // n, keys % n], axis=1), counts


def _unique_keys(keys: np.ndarray):
    """Sorted unique int64 keys and their counts, as ``np.unique`` gives
    them, by one sort: some numpy versions' ``np.unique`` takes a hash path
    that is far slower than a sort on a few million keys."""
    keys = np.sort(keys)
    if keys.size == 0:
        return keys, np.zeros(0, np.int64)
    first = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
    return keys[first], np.diff(np.append(first, len(keys)))


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
