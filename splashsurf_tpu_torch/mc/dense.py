"""Vectorized marching cubes over dense point-value grids (PyTorch port of
``splashsurf_tpu.mc.dense``).

A corner is "inside" iff value >= iso (narrow_band_extraction.rs:79-100);
vertices interpolate linearly, t = (iso - v0) / (v1 - v0). There is one
vertex per active grid edge, so no vertex deduplication is needed. Vertices
come in flat edge order (all x-edges, then y, then z, each in base-point
order) and triangles in cell order, then case-table slot order: the same
lists as the reference package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch.kernels import rounded
from splashsurf_tpu_torch.mc import lut
from splashsurf_tpu_torch.placement import on_device


def edge_layout(n_points: Tuple[int, int, int]):
    """Shapes, strides and flat offsets of the three per-axis edge arrays:
    x-edges (nx-1, ny, nz), y-edges (nx, ny-1, nz), z-edges (nx, ny, nz-1),
    concatenated in x, y, z order."""
    nx, ny, nz = n_points
    shapes = [(nx - 1, ny, nz), (nx, ny - 1, nz), (nx, ny, nz - 1)]
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    offsets = [0, sizes[0], sizes[0] + sizes[1]]
    strides = [(s[1] * s[2], s[2], 1) for s in shapes]
    total = sizes[0] + sizes[1] + sizes[2]
    return shapes, strides, offsets, total


def _local_edge_coeffs(n_points: Tuple[int, int, int]):
    """Per-local-edge affine map from cell ijk to flat edge id:
    flat_edge(e, (ci, cj, ck)) = CONST[e] + CI[e]*ci + CJ[e]*cj + CK[e]*ck."""
    _, strides, offsets, _ = edge_layout(n_points)
    const = np.zeros(lut.NUM_EDGES, dtype=np.int64)
    ci = np.zeros(lut.NUM_EDGES, dtype=np.int64)
    cj = np.zeros(lut.NUM_EDGES, dtype=np.int64)
    ck = np.zeros(lut.NUM_EDGES, dtype=np.int64)
    for e in range(lut.NUM_EDGES):
        a = int(lut.EDGE_AXIS[e])
        bo = lut.EDGE_BASE_OFFSET[e].astype(np.int64)
        s = strides[a]
        const[e] = offsets[a] + bo[0] * s[0] + bo[1] * s[1] + bo[2] * s[2]
        ci[e], cj[e], ck[e] = s
    return const, ci, cj, ck


def lut_tensors(device):
    """(TRI_COUNT (256,), TRI_TABLE (256, M, 3) with -1 slots set to 0), as
    int64 tensors on ``device``."""
    count = torch.as_tensor(lut.TRI_COUNT.astype(np.int64), device=device)
    tab = np.where(lut.TRI_TABLE >= 0, lut.TRI_TABLE, 0).astype(np.int64)
    return count, torch.as_tensor(tab, device=device)


def _case_indices(inside: torch.Tensor) -> torch.Tensor:
    """Per-cell case index from the (nx, ny, nz) inside mask."""
    nx, ny, nz = inside.shape
    case = torch.zeros(
        (nx - 1, ny - 1, nz - 1), dtype=torch.int32, device=inside.device
    )
    for c in range(8):
        oi, oj, ok = (c >> 2) & 1, (c >> 1) & 1, c & 1
        corner = inside[oi : oi + nx - 1, oj : oj + ny - 1, ok : ok + nz - 1]
        case |= corner.to(torch.int32) << c
    return case


def _mc_counts(values: torch.Tensor, iso) -> Tuple[int, int]:
    """(vertex count, triangle count) of the mesh marching cubes would emit."""
    inside = values >= rounded(iso, values.dtype)
    n_verts = 0
    for a in range(3):
        sl0 = tuple(slice(0, -1) if d == a else slice(None) for d in range(3))
        sl1 = tuple(slice(1, None) if d == a else slice(None) for d in range(3))
        n_verts += int(torch.count_nonzero(inside[sl0] != inside[sl1]))
    count, _ = lut_tensors(values.device)
    n_tris = int(count[_case_indices(inside).long()].sum())
    return n_verts, n_tris


class MarchingCubesResult(NamedTuple):
    """Capacity-padded marching cubes output (tensors on the field's device)."""

    vertices: torch.Tensor  # (Vcap, 3) float, zero past the count
    triangles: torch.Tensor  # (Tcap, 3) int32 vertex indices, zero past the count
    num_vertices: torch.Tensor  # () int64, the true count
    num_triangles: torch.Tensor  # () int64, the true count
    vertex_edges: torch.Tensor  # (Vcap,) int64 flat edge id of each vertex, -1 past the count


def _mc_mesh(values: torch.Tensor, iso: float, grid_min, cell_size: float, index_offset=None):
    """The exact-size mesh of a (nx, ny, nz) field on its device: (vertices
    (V, 3), triangles (T, 3) int32, vertex edge ids (V,) int64). Point
    (i, j, k) lies at grid_min + ((i, j, k) + index_offset) * cell_size."""
    dtype, dev = values.dtype, values.device
    iso = rounded(iso, dtype)
    cs = rounded(cell_size, dtype)
    mn = [rounded(float(t), dtype) for t in grid_min]
    off = [0, 0, 0] if index_offset is None else [int(o) for o in index_offset]
    inside = values >= iso
    nx, ny, nz = values.shape

    # vertices: one per active edge, flat edge order
    masks, comps = [], [[], [], []]
    for a in range(3):
        sl0 = tuple(slice(0, -1) if d == a else slice(None) for d in range(3))
        sl1 = tuple(slice(1, None) if d == a else slice(None) for d in range(3))
        m = inside[sl0] != inside[sl1]
        ijk = torch.nonzero(m)  # row-major == flat order
        v0 = values[sl0][m]
        denom = values[sl1][m] - v0
        t = torch.clamp(
            (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom),
            0.0,
            1.0,
        )
        for d in range(3):
            pos = mn[d] + (ijk[:, d] + off[d]).to(dtype) * cs
            comps[d].append(pos + t * cs if d == a else pos)
        masks.append(m.reshape(-1))
    vertices = torch.stack([torch.cat(c) for c in comps], dim=1)
    mask = torch.cat(masks)
    vidx = torch.cumsum(mask, 0) - 1  # vertex id of each edge

    # triangles: cell order, then case-table slot order
    count_t, tab_t = lut_tensors(dev)
    case = _case_indices(inside).reshape(-1).long()
    counts = count_t[case]
    cells = torch.nonzero(counts).squeeze(1)
    ccounts = counts[cells]
    n_tris = int(ccounts.sum())
    tri_cell = torch.repeat_interleave(cells, ccounts, output_size=n_tris)
    starts = torch.cumsum(ccounts, 0) - ccounts
    slot = torch.arange(n_tris, device=dev) - torch.repeat_interleave(
        starts, ccounts, output_size=n_tris
    )
    cy, cz = ny - 1, nz - 1
    ci, cj, ck = tri_cell // (cy * cz), (tri_cell // cz) % cy, tri_cell % cz
    coeffs = [
        torch.as_tensor(c, device=dev) for c in _local_edge_coeffs((nx, ny, nz))
    ]
    tcase = case[tri_cell]
    cols = []
    for corner in range(3):
        local = tab_t[tcase, slot, corner]
        edge = (
            coeffs[0][local]
            + coeffs[1][local] * ci
            + coeffs[2][local] * cj
            + coeffs[3][local] * ck
        )
        cols.append(vidx[edge])
    triangles = torch.stack(cols, dim=1).to(torch.int32)
    return vertices, triangles, torch.nonzero(mask).squeeze(1)


def _padded(x: torch.Tensor, capacity: int, fill) -> torch.Tensor:
    """The first ``capacity`` rows of ``x``, ``fill`` past its end."""
    out = torch.full((capacity,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    n = min(capacity, x.shape[0])
    out[:n] = x[:n]
    return out


def marching_cubes_padded(
    values,
    iso,
    grid_min,
    cell_size,
    vertex_capacity: int,
    triangle_capacity: int,
    index_offset=None,
    device=None,
) -> MarchingCubesResult:
    """Marching cubes on a dense (nx, ny, nz) point-value grid, with
    capacity-padded outputs: the first ``vertex_capacity`` vertices (and
    their flat edge ids) and ``triangle_capacity`` triangles, and the true
    counts even past the capacities. ``grid_min``/``cell_size`` place the
    grid in space; ``index_offset`` shifts point indices to a global grid
    (subdomains). A tensor runs on its own device, an array on ``device``
    (``placement.on_device``)."""
    values = on_device(values, device=device)
    vertices, triangles, edges = _mc_mesh(values, iso, grid_min, cell_size, index_offset)
    count = lambda x: torch.tensor(x.shape[0], device=values.device)
    return MarchingCubesResult(
        vertices=_padded(vertices, vertex_capacity, 0.0),
        triangles=_padded(triangles, triangle_capacity, 0),
        num_vertices=count(vertices),
        num_triangles=count(triangles),
        vertex_edges=_padded(edges, vertex_capacity, -1),
    )


def decode_edge_flat(edge_flat, n_points: Tuple[int, int, int], device=None):
    """Flat edge ids -> (axis (...,), base point ijk (..., 3)), int64: the
    inverse of ``edge_layout``'s x, y, z concatenation. Ids < 0 decode to
    axis 0, ijk 0."""
    _, strides, offsets, _ = edge_layout(n_points)
    safe = on_device(edge_flat, device=device).long().clamp_min(0)
    axis = (safe >= offsets[1]).long() + (safe >= offsets[2]).long()
    local = safe - torch.as_tensor(offsets, device=safe.device)[axis]
    s0 = torch.as_tensor([s[0] for s in strides], device=safe.device)[axis]
    s1 = torch.as_tensor([s[1] for s in strides], device=safe.device)[axis]
    i = local // s0
    rem = local - i * s0
    j = rem // s1
    return axis, torch.stack([i, j, rem - j * s1], dim=-1)


def marching_cubes(
    values,
    iso: float,
    cube_size: float = 1.0,
    translation=(0.0, 0.0, 0.0),
    device=None,
):
    """Dense scalar field (nx, ny, nz) -> ``TriMesh3d`` with host arrays.

    A tensor runs on its own device; a numpy array on ``device``, by
    default CUDA (RuntimeError where CUDA is absent).
    Equivalent of ``pysplashsurf.marching_cubes`` on a raw 3-D array
    (pysplashsurf/src/marching_cubes.rs:106-178).
    """
    from splashsurf_tpu_torch.mesh import TriMesh3d

    values = on_device(values, device=device)
    vertices, triangles, _ = _mc_mesh(values, iso, translation, cube_size)
    return TriMesh3d(
        vertices=vertices.cpu().numpy(), triangles=triangles.cpu().numpy()
    )
