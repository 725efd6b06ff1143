"""Mesh post-processing: smoothing, cleanup, decimation, tri->quad
(PyTorch port of ``splashsurf_tpu.postprocess``; reference:
splashsurf_lib/src/postprocessing.rs).

Smoothing runs on the device as padded-CSR neighbour gathers, every
iteration on the device; topological edits (Moore/Warren cleanup, barnacle
decimation, quad merging) run on the host over the half-edge mesh, with the
collapses in the native engine (``native``) where it builds, the same numpy
code as the reference package's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch.halfedge import HalfEdgeTriMesh, IllegalCollapse
from splashsurf_tpu_torch.mesh import (
    MixedTriQuadMesh3d,
    TriMesh3d,
    vertex_vertex_connectivity_csr,
)
from splashsurf_tpu_torch.profiling import profile
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.uniform_grid import UniformGrid


# ---------------------------------------------------------------------------
# Laplacian smoothing (device)
# ---------------------------------------------------------------------------


def _csr_to_padded(offsets: np.ndarray, neighbors: np.ndarray, num_vertices: int):
    counts = np.diff(offsets)
    width = max(int(counts.max()) if len(counts) else 1, 1)
    pad = np.full((num_vertices, width), num_vertices, dtype=np.int64)
    rows = np.repeat(np.arange(num_vertices, dtype=np.int64), counts)
    cols = np.arange(len(neighbors), dtype=np.int64) - np.repeat(
        offsets[:-1], counts
    )
    pad[rows, cols] = neighbors
    return pad, counts


def _padded_neighbors(triangles, num_vertices: int, device):
    """The (V, W) padded neighbour table (padding index V) and the (V,)
    neighbour counts on ``device``, built from the host triangle list."""
    if isinstance(triangles, torch.Tensor):
        triangles = triangles.cpu().numpy()
    offsets, neigh = vertex_vertex_connectivity_csr(np.asarray(triangles), num_vertices)
    padded, counts = _csr_to_padded(offsets, neigh, num_vertices)
    return torch.as_tensor(padded, device=device), torch.as_tensor(counts, device=device)


def _gather_sum(x: torch.Tensor, padded: torch.Tensor) -> torch.Tensor:
    """Sum of each vertex's neighbour rows; the padding row adds 0."""
    ext = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return torch.sum(ext[padded], dim=1)


def laplacian_smoothing(
    vertices,
    triangles,
    iterations: int,
    beta: float,
    weights,
    device=None,
):
    """Weighted Laplacian smoothing (postprocessing.rs:17-52).

    Each iteration moves vertex i toward the mean of its neighbors by
    ``beta * weights[i]``; all iterations run on the device. A tensor stays
    on its own device and comes back as a tensor; an array goes to
    ``device`` (default CUDA) and comes back as an array."""
    verts = on_device(vertices, device=device)
    nv = verts.shape[0]
    with profile("vertex connectivity"):
        padded, counts = _padded_neighbors(triangles, nv, verts.device)
    w = weights if isinstance(weights, torch.Tensor) else torch.as_tensor(np.asarray(weights))
    beta_eff = (
        torch.tensor(beta, dtype=verts.dtype, device=verts.device)
        * w.to(device=verts.device, dtype=verts.dtype)
    )[:, None]
    denom = torch.clamp_min(counts, 1).to(verts.dtype)[:, None]
    has_neighbors = (counts > 0)[:, None]
    with profile("iterations", block_on=verts):
        for _ in range(iterations):
            mean = _gather_sum(verts, padded) / denom
            verts = torch.where(has_neighbors, verts * (1 - beta_eff) + mean * beta_eff, verts)
    return verts if isinstance(vertices, torch.Tensor) else verts.cpu().numpy()



def par_laplacian_smoothing_inplace(
    mesh, vertex_connectivity, iterations: int, beta: float, weights, device=None
):
    """Reference-named wrapper: ``mesh.vertices`` becomes the
    ``laplacian_smoothing`` of the mesh (``vertex_connectivity`` is not
    read; the connectivity comes from the triangles). Returns ``mesh``."""
    mesh.vertices = laplacian_smoothing(
        mesh.vertices, mesh.triangles, iterations, beta, weights, device=device
    )
    return mesh

def laplacian_smoothing_normals(
    normals, triangles, num_vertices: int, iterations: int, device=None
):
    """Normal-field smoothing: unweighted neighbor averaging + renormalize
    (postprocessing.rs:55-93), all iterations on the device; tensors and
    arrays as in ``laplacian_smoothing``."""
    n = on_device(normals, device=device)
    with profile("vertex connectivity"):
        padded, _ = _padded_neighbors(triangles, num_vertices, n.device)
    with profile("iterations", block_on=n):
        for _ in range(iterations):
            s = _gather_sum(n, padded)
            norm = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
            n = s / torch.where(norm > 0, norm, torch.ones_like(norm))
    return n if isinstance(normals, torch.Tensor) else n.cpu().numpy()


# ---------------------------------------------------------------------------
# marching cubes cleanup (Moore/Warren displacement; host)
# ---------------------------------------------------------------------------


def marching_cubes_cleanup(
    mesh: TriMesh3d,
    grid: UniformGrid,
    max_rel_snap_distance: Optional[float] = None,
    max_iter: int = 5,
    keep_vertices: bool = False,
    return_tri_map: bool = False,
) -> Tuple[TriMesh3d, List[List[int]]]:
    """Moore/Warren "mesh displacement" decimation (postprocessing.rs:99-242):
    collapse mesh vertices that share the same nearest grid point, averaging
    positions, so each MC cell contributes at most ~one vertex."""
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    cell = np.floor(
        (verts - np.asarray(grid.min)) / grid.cell_size
    ).astype(np.int64)
    frac = verts - (np.asarray(grid.min) + cell * grid.cell_size)
    nearest = cell + (frac > grid.cell_size / 2.0)
    npx, npy, npz = grid.n_points
    nearest_flat = (nearest[:, 0] * npy + nearest[:, 1]) * npz + nearest[:, 2]

    max_snap_sq = None
    if max_rel_snap_distance is not None:
        max_snap_sq = (max_rel_snap_distance * grid.cell_size) ** 2
    grid_coords = np.asarray(grid.min) + nearest * grid.cell_size

    from splashsurf_tpu_torch import native

    if native.available():
        with profile("collapses (native)"):
            v_out, t_raw, tri_valid, owner, _n = native.mc_cleanup(
                verts,
                mesh.triangles,
                nearest_flat,
                grid_coords,
                -1.0 if max_snap_sq is None else max_snap_sq,
                max_iter,
            )
        with profile("vertex map"):
            return _finalize_collapsed(
                v_out, t_raw, tri_valid, owner, keep_vertices, return_tri_map
            )

    he = HalfEdgeTriMesh(verts, mesh.triangles)
    sum_count = np.ones(len(verts), dtype=np.int64)

    for _ in range(max_iter):
        collapses = 0
        for v0 in range(len(verts)):
            if not he.is_valid_vertex(v0):
                continue
            if max_snap_sq is not None:
                d0 = he.vertices[v0] - grid_coords[v0]
                if d0 @ d0 > max_snap_sq:
                    continue
            for v1 in list(he.adj[v0]):
                if nearest_flat[v0] != nearest_flat[v1]:
                    continue
                if max_snap_sq is not None:
                    d1 = he.vertices[v1] - grid_coords[v1]
                    if d1 @ d1 > max_snap_sq:
                        continue
                if not he.is_valid_vertex(v1):
                    continue
                try:
                    he.try_collapse(v1, v0)
                except IllegalCollapse:
                    continue
                collapses += 1
                n0, n1 = sum_count[v0], sum_count[v1]
                he.vertices[v0] = (he.vertices[v0] * n0 + he.vertices[v1] * n1) / (
                    n0 + n1
                )
                sum_count[v0] = n0 + n1
        if collapses == 0:
            break

    return he.into_parts(keep_vertices, return_tri_map)


def _finalize_collapsed(
    verts, tris_raw, tri_valid, owner, keep_vertices, return_tri_map=False
):
    """Assemble a TriMesh3d + vertex_map from native collapse outputs."""
    tris = tris_raw[tri_valid]
    tri_map = np.nonzero(tri_valid)[0]
    nv = len(verts)
    merged_from = [[] for _ in range(nv)]
    for v in range(nv):
        merged_from[v if owner[v] < 0 else int(owner[v])].append(v)
    if keep_vertices:
        mesh = TriMesh3d(verts.astype(np.float32), tris.astype(np.int32))
        vertex_map = merged_from
    else:
        used = np.zeros(nv, dtype=bool)
        if len(tris):
            used[tris.ravel()] = True
        new_index = np.cumsum(used) - 1
        mesh = TriMesh3d(
            vertices=verts[used].astype(np.float32),
            triangles=new_index[tris].astype(np.int32),
        )
        vertex_map = [merged_from[v] for v in np.nonzero(used)[0]]
    if return_tri_map:
        return mesh, vertex_map, tri_map
    return mesh, vertex_map


def _remap_attributes(meshdata, mesh, vertex_map, tri_map):
    """Remap point/cell attributes of ``meshdata`` onto the collapsed
    ``mesh``: point data averages over each output vertex's merged
    originals; cell data follows the surviving-triangle map
    (MeshWithData parity, mesh.rs:1227+)."""
    from splashsurf_tpu_torch.mesh import MeshAttribute, MeshWithData

    point_attributes = []
    for a in meshdata.point_attributes:
        data = np.asarray(a.data)
        counts = np.asarray([len(m) for m in vertex_map], np.int64)
        flat = np.concatenate(
            [np.asarray(m, np.int64) for m in vertex_map]
        ) if len(vertex_map) else np.zeros(0, np.int64)
        seg = np.repeat(np.arange(len(vertex_map)), counts)
        if np.issubdtype(data.dtype, np.floating):
            sums = np.zeros((len(vertex_map),) + data.shape[1:], data.dtype)
            np.add.at(sums, seg, data[flat])
            out = sums / np.maximum(counts, 1).reshape(
                (-1,) + (1,) * (data.ndim - 1)
            ).astype(data.dtype)
        else:
            # integer/index data: take the first merged original's value
            first = np.array([m[0] if m else 0 for m in vertex_map], np.int64)
            out = data[first]
        point_attributes.append(MeshAttribute(a.name, out))
    cell_attributes = [
        MeshAttribute(a.name, np.asarray(a.data)[tri_map])
        for a in meshdata.cell_attributes
    ]
    return MeshWithData(
        mesh=mesh,
        point_attributes=point_attributes,
        cell_attributes=cell_attributes,
    )


def marching_cubes_cleanup_with_data(
    meshdata,
    grid: UniformGrid,
    max_rel_snap_distance: Optional[float] = None,
    max_iter: int = 5,
    keep_vertices: bool = False,
):
    """MC cleanup on a ``MeshWithData``: point attributes are averaged over
    merged vertices, cell attributes follow the surviving triangles."""
    mesh, vertex_map, tri_map = marching_cubes_cleanup(
        meshdata.mesh, grid, max_rel_snap_distance, max_iter,
        keep_vertices=keep_vertices, return_tri_map=True,
    )
    return _remap_attributes(meshdata, mesh, vertex_map, tri_map)


def decimation_with_data(meshdata, keep_vertices: bool = False):
    """Barnacle decimation on a ``MeshWithData`` (attributes remapped)."""
    mesh, vertex_map, tri_map = decimation(
        meshdata.mesh, keep_vertices=keep_vertices, return_tri_map=True
    )
    return _remap_attributes(meshdata, mesh, vertex_map, tri_map)


# ---------------------------------------------------------------------------
# barnacle decimation (host)
# ---------------------------------------------------------------------------


def decimation(
    mesh: TriMesh3d, keep_vertices: bool = False, return_tri_map: bool = False
):
    """Merge "barnacle" sliver configurations (postprocessing.rs:244-263)."""
    from splashsurf_tpu_torch import native

    if native.available():
        return _decimation_native(mesh, keep_vertices, return_tri_map)
    he = HalfEdgeTriMesh(mesh.vertices, mesh.triangles)
    merge_single_barnacle_configurations(he)
    merge_double_barnacle_configurations(he)
    return he.into_parts(keep_vertices, return_tri_map)


def _decimation_native(
    mesh: TriMesh3d, keep_vertices: bool, return_tri_map: bool = False
):
    """Barnacle decimation with candidate detection in Python (set logic on
    ring sizes from the native helper) and collapses in C++."""
    from splashsurf_tpu_torch import native

    with profile("half-edge mesh"):
        he = HalfEdgeTriMesh(mesh.vertices, mesh.triangles)
    # Candidate detection stays in Python (set logic over ring valences);
    # the collapse execution runs natively.
    with profile("barnacle detection"):
        collapses = _collect_single_barnacle_collapses(he) + _collect_double_barnacle_collapses(he)
    if not collapses:
        return he.into_parts(keep_vertices, return_tri_map)
    with profile("collapses (native)"):
        verts, tris_raw, tri_valid, owner, _n = native.process_collapses(
            mesh.vertices, mesh.triangles, np.asarray(collapses, np.int64)
        )
    with profile("vertex map"):
        return _finalize_collapsed(
            verts, tris_raw, tri_valid, owner, keep_vertices, return_tri_map
        )


def _collect_single_barnacle_collapses(he: HalfEdgeTriMesh):
    candidates = set()
    for v in range(len(he.vertices)):
        if not he.is_valid_vertex(v) or he.vertex_one_ring_len(v) != 4:
            continue
        lens = [he.vertex_one_ring_len(j) for j in he.adj[v]]
        if all(4 <= l <= 6 for l in lens) and sum(lens) == 20:
            candidates.add(v)
    candidates = {
        c for c in candidates if not any(j in candidates for j in he.adj[c])
    }
    collapses = {}
    for c in candidates:
        for i in list(he.adj[c]):
            collapses[i] = c
    return list(collapses.items())


def _collect_double_barnacle_collapses(he: HalfEdgeTriMesh):
    return detect_double_barnacle_collapses(he)


def _process_collapse_queue(he: HalfEdgeTriMesh, collapses):
    remaining = []
    for v_from, v_to in collapses:
        if not he.has_edge(v_from, v_to):
            continue
        try:
            he.try_collapse(v_from, v_to)
        except IllegalCollapse as e:
            if "one-ring" in str(e):
                remaining.append((v_from, v_to))
    return remaining


def _process_collapse_queue_iterative(he: HalfEdgeTriMesh, collapses):
    remaining = _process_collapse_queue(he, collapses)
    it = 1
    while remaining and it < 5:
        it += 1
        remaining = _process_collapse_queue(he, remaining)


def merge_single_barnacle_configurations(he: HalfEdgeTriMesh):
    """Single barnacle: a valence-4 vertex whose ring valences sum to 20
    with each in [4, 6] (postprocessing.rs:445-530). The ring is collapsed
    into the center."""
    candidates = set()
    for v in range(len(he.vertices)):
        if not he.is_valid_vertex(v) or he.vertex_one_ring_len(v) != 4:
            continue
        ring = list(he.adj[v])
        lens = [he.vertex_one_ring_len(j) for j in ring]
        if all(4 <= l <= 6 for l in lens) and sum(lens) == 20:
            candidates.add(v)
    # drop adjacent candidates
    candidates = {
        c for c in candidates if not any(j in candidates for j in he.adj[c])
    }
    collapses = {}
    for c in candidates:
        for i in list(he.adj[c]):
            collapses[i] = c
    _process_collapse_queue_iterative(he, list(collapses.items()))


def merge_double_barnacle_configurations(he: HalfEdgeTriMesh):
    """Double barnacle: two adjacent valence-5 centers with ring valence
    multiset [5,5,5,6,6] (postprocessing.rs:532-686)."""
    _process_collapse_queue_iterative(he, detect_double_barnacle_collapses(he))


def detect_double_barnacle_collapses(he: HalfEdgeTriMesh):
    """Detection half of the double-barnacle merge: returns the collapse
    queue [(v_from, v_to), ...] without mutating the mesh."""

    def is_center(i):
        if not he.is_valid_vertex(i) or he.vertex_one_ring_len(i) != 5:
            return False
        lens = sorted(he.vertex_one_ring_len(j) for j in he.adj[i])
        return lens == [5, 5, 5, 6, 6]

    pairs = set()
    for i in range(len(he.vertices)):
        if not is_center(i):
            continue
        centers = [j for j in he.adj[i] if is_center(j)]
        if len(centers) == 1:
            pairs.add((min(i, centers[0]), max(i, centers[0])))

    # filter overlapping pairs (a vertex participating in two pairs)
    def overlapping(i, j):
        pair = (min(i, j), max(i, j))
        for k in he.adj[i]:
            other = (min(i, k), max(i, k))
            if k != j and other < pair and other in pairs:
                return True
        return False

    pairs = {
        (i, j) for (i, j) in pairs if not (overlapping(i, j) or overlapping(j, i))
    }

    # filter pairs with adjacent neighborhoods belonging to other pairs
    center_to_pair = {}
    for i, j in pairs:
        center_to_pair[i] = (i, j)
        center_to_pair[j] = (i, j)

    def adjacent_to_other(i, j):
        pair = (min(i, j), max(i, j))
        for k in he.adj[i]:
            if k == j:
                continue
            for l in he.adj[k]:
                if l in (i, j):
                    continue
                other = center_to_pair.get(l)
                if other is not None and other < pair:
                    return True
        return False

    pairs = {
        (i, j)
        for (i, j) in pairs
        if not (adjacent_to_other(i, j) or adjacent_to_other(j, i))
    }

    collapses = {}
    for i, j in pairs:

        def insert(i, j, k):
            if k == j:
                return
            if all(l != j for l in he.adj[k]):
                collapses[k] = i
            elif np.linalg.norm(he.vertices[k] - he.vertices[i]) <= np.linalg.norm(
                he.vertices[k] - he.vertices[j]
            ):
                collapses[k] = i
            else:
                collapses[k] = j

        for k in list(he.adj[i]):
            insert(i, j, k)
        for k in list(he.adj[j]):
            insert(j, i, k)
    return list(collapses.items())


# ---------------------------------------------------------------------------
# triangle -> quad conversion (host, vectorized numpy)
# ---------------------------------------------------------------------------


def convert_tris_to_quads(
    mesh: TriMesh3d,
    non_squareness_limit: float = 1.75,
    normal_angle_limit_rad: float = np.deg2rad(10),
    max_interior_angle_rad: float = np.deg2rad(135),
) -> MixedTriQuadMesh3d:
    """Merge triangle pairs into quads when square enough
    (postprocessing.rs:689-910)."""
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    tris = np.asarray(mesh.triangles, dtype=np.int64)
    nt = len(tris)
    if nt == 0:
        return MixedTriQuadMesh3d(
            vertices=mesh.vertices, triangles=mesh.triangles, quads=np.zeros((0, 4), np.int32)
        )

    # host numpy normals: this whole pass is host-side and shipping a
    # multi-M-tri mesh through the device costs a round trip for nothing
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    n = np.cross(b - a, c - a)
    with np.errstate(invalid="ignore", divide="ignore"):
        n /= np.linalg.norm(n, axis=1, keepdims=True)

    # unique shared edges -> triangle pairs; edges are packed into one int64
    # key (a 2-column lexsort measured 5s at canyon scale on a slow host)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    nv = len(verts)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    key = lo * nv + hi
    tri_ids = np.tile(np.arange(nt), 3)
    order = np.argsort(key, kind="stable")
    ks, ts = key[order], tri_ids[order]
    same = ks[1:] == ks[:-1]
    pair_i = ts[:-1][same]
    pair_j = ts[1:][same]
    so = order[:-1][same]
    shared = np.stack([lo[so], hi[so]], axis=1)  # (P, 2) sorted vertex pair

    min_dot = np.cos(normal_angle_limit_rad)
    sqrt2 = np.sqrt(2.0)

    # normal-alignment prefilter
    dots = np.einsum("ij,ij->i", n[pair_i], n[pair_j])
    keep = dots >= min_dot
    pi, pj, sh = pair_i[keep], pair_j[keep], shared[keep]
    P = len(pi)
    if P:
        # vectorized quad construction: the missing vertex of tri_j is its
        # vertex sum minus the shared edge; the insertion slot follows which
        # of tri_i's first two vertices lie on the shared edge
        ti3, tj3 = tris[pi], tris[pj]
        missing = tj3.sum(axis=1) - sh[:, 0] - sh[:, 1]
        on_edge = lambda col: (col == sh[:, 0]) | (col == sh[:, 1])
        in0, in1 = on_edge(ti3[:, 0]), on_edge(ti3[:, 1])
        t0, t1, t2 = ti3[:, 0], ti3[:, 1], ti3[:, 2]
        q = np.empty((P, 4), np.int64)
        q[:, 0] = t0
        q[:, 1] = np.where(in0 & in1, missing, t1)
        q[:, 2] = np.where(in0 & in1, t1, np.where(in0, t2, missing))
        q[:, 3] = np.where(in0 & ~in1, missing, t2)

        V = verts[q]  # (P, 4, 3)
        diag = np.linalg.norm(verts[sh[:, 0]] - verts[sh[:, 1]], axis=1)
        max_len = diag / sqrt2 * non_squareness_limit
        min_len = diag / sqrt2 / non_squareness_limit
        edges = V[:, [1, 2, 3, 0]] - V  # (P, 4, 3)
        lens = np.linalg.norm(edges, axis=2)  # (P, 4)
        ok = ((lens >= min_len[:, None]) & (lens <= max_len[:, None])).all(axis=1)

        # interior angles, split by the diagonal to the opposite corner:
        # corner specs (c, prev, next, opposite) matching postprocessing.rs
        with np.errstate(invalid="ignore", divide="ignore"):
            for c, p, nn, o in ((0, 3, 1, 2), (1, 0, 2, 3), (2, 3, 1, 0), (3, 2, 0, 1)):
                dp = V[:, p] - V[:, c]
                dm = V[:, o] - V[:, c]
                dn = V[:, nn] - V[:, c]
                lp = np.linalg.norm(dp, axis=1)
                lm = np.linalg.norm(dm, axis=1)
                ln = np.linalg.norm(dn, axis=1)
                a1 = np.arccos(
                    np.clip(np.einsum("ij,ij->i", dp, dm) / (lp * lm), -1, 1)
                )
                a2 = np.arccos(
                    np.clip(np.einsum("ij,ij->i", dm, dn) / (lm * ln), -1, 1)
                )
                ok &= (a1 + a2) <= max_interior_angle_rad
        cand = np.nonzero(ok)[0]
    else:
        cand = np.zeros(0, np.int64)

    # Greedy first-come matching, vectorized: a candidate wins a round iff it
    # is the lowest-index live candidate touching BOTH its triangles; winners
    # retire their triangles and the rule repeats. This produces exactly the
    # sequential greedy (lexicographically first maximal) matching in
    # O(log M) numpy rounds instead of an O(M) interpreter loop.
    tic, tjc, qc = pi[cand], pj[cand], (q[cand] if len(cand) else np.zeros((0, 4), np.int64))
    M = len(cand)
    alive = np.ones(M, bool)
    used = np.zeros(nt, bool)
    accepted = np.zeros(M, bool)
    while True:
        act = np.nonzero(alive)[0]
        if len(act) == 0:
            break
        first = np.full(nt, M, np.int64)
        np.minimum.at(first, tic[act], act)
        np.minimum.at(first, tjc[act], act)
        win = act[(first[tic[act]] == act) & (first[tjc[act]] == act)]
        accepted[win] = True
        used[tic[win]] = True
        used[tjc[win]] = True
        alive &= ~(used[tic] | used[tjc])

    return MixedTriQuadMesh3d(
        vertices=mesh.vertices,
        triangles=tris[~used].astype(np.int32),
        quads=qc[accepted].astype(np.int32),
    )
