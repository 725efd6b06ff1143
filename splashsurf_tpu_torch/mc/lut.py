"""Programmatic generation of the marching cubes case table.

Instead of transcribing the classic 256-case triangle table (reference:
splashsurf_lib/src/marching_cubes/marching_cubes_lut.rs), the table is
*derived* at import time by walking iso-line cycles over the cube faces:

  1. An edge is active iff its endpoints straddle the iso value.
  2. On every cube face the active edges pair up into iso-line segments.
     Faces with four active edges are ambiguous (two diagonal corners
     inside); we resolve them with a fixed local rule — connect the two
     active edges incident to each *inside* corner (equivalent to assuming
     the face center lies outside). Because the rule depends only on the
     face's corner signs, the two cells sharing a face always agree, which
     makes the extracted surface watertight across cells by construction
     (the classic table needs the same property; here it is enforced rather
     than transcribed).
  3. Chains of paired edges form closed polygons, oriented so triangle
     normals point from the inside region (value > iso) to the outside,
     then fan-triangulated.

Cube conventions:
  - corner index c in [0, 8): offset (i, j, k) = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
  - edge index e in [0, 12): axis-major; ``EDGE_AXIS[e]`` is the axis (0=x,
    1=y, 2=z) and ``EDGE_BASE_OFFSET[e]`` the corner offset of the endpoint
    with coordinate 0 along that axis. Within an axis, edges are ordered by
    base corner index.
  - case index: bit c set iff corner c is inside (value > iso).
"""

from __future__ import annotations

import itertools

import numpy as np

NUM_EDGES = 12

# -- cube topology -----------------------------------------------------------

_CORNER_OFFSETS = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=np.int8
)


def _corner_index(off) -> int:
    return int(off[0]) * 4 + int(off[1]) * 2 + int(off[2])


def _build_edges():
    axes, bases = [], []
    for a in range(3):
        for c in range(8):
            off = _CORNER_OFFSETS[c]
            if off[a] == 0:
                axes.append(a)
                bases.append(off.copy())
    return np.array(axes, dtype=np.int8), np.array(bases, dtype=np.int8)


EDGE_AXIS, EDGE_BASE_OFFSET = _build_edges()

# Endpoint corner indices of each edge.
_EDGE_CORNERS = np.zeros((NUM_EDGES, 2), dtype=np.int8)
for _e in range(NUM_EDGES):
    p0 = EDGE_BASE_OFFSET[_e].copy()
    p1 = p0.copy()
    p1[EDGE_AXIS[_e]] = 1
    _EDGE_CORNERS[_e] = (_corner_index(p0), _corner_index(p1))

# Faces: (axis, side). A face contains the 4 corners with offset[axis] == side.
_FACES = [(a, s) for a in range(3) for s in (0, 1)]


def _edge_on_face(e: int, face) -> bool:
    fa, fs = face
    return EDGE_AXIS[e] != fa and EDGE_BASE_OFFSET[e][fa] == fs


_EDGE_FACES = [[f for f in range(6) if _edge_on_face(e, _FACES[f])] for e in range(NUM_EDGES)]
assert all(len(fs) == 2 for fs in _EDGE_FACES)


def _edge_touches_corner(e: int, c: int) -> bool:
    return c in (_EDGE_CORNERS[e, 0], _EDGE_CORNERS[e, 1])


def _face_corners(face) -> list:
    fa, fs = face
    return [c for c in range(8) if _CORNER_OFFSETS[c][fa] == fs]


# -- per-case polygon extraction ------------------------------------------------


def _face_pairing(case: int, face_id: int, active: list) -> dict:
    """Pair active edges on one face. Returns {edge: partner_edge}."""
    face = _FACES[face_id]
    fedges = [e for e in active if _edge_on_face(e, face)]
    pairs = {}
    if len(fedges) == 0:
        return pairs
    if len(fedges) == 2:
        a, b = fedges
        pairs[a] = b
        pairs[b] = a
        return pairs
    assert len(fedges) == 4, f"face with {len(fedges)} active edges in case {case}"
    # Ambiguous face: two diagonal inside corners. Connect the two active
    # edges incident to each inside corner (face center treated as outside).
    inside_corners = [
        c for c in _face_corners(face) if (case >> c) & 1
    ]
    assert len(inside_corners) == 2
    for c in inside_corners:
        inc = [e for e in fedges if _edge_touches_corner(e, c)]
        assert len(inc) == 2
        a, b = inc
        pairs[a] = b
        pairs[b] = a
    return pairs


def _case_polygons(case: int) -> list:
    """Closed, consistently oriented iso-polygons (lists of edge ids)."""
    inside = [(case >> c) & 1 for c in range(8)]
    active = [
        e
        for e in range(NUM_EDGES)
        if inside[_EDGE_CORNERS[e, 0]] != inside[_EDGE_CORNERS[e, 1]]
    ]
    if not active:
        return []

    # partner[(edge, face)] -> edge
    partner = {}
    for f in range(6):
        for e, p in _face_pairing(case, f, active).items():
            partner[(e, f)] = p

    polygons = []
    visited = set()
    for start in active:
        if start in visited:
            continue
        cycle = [start]
        visited.add(start)
        # Enter the cycle through an arbitrary face of the start edge.
        face = _EDGE_FACES[start][0]
        cur = partner[(start, face)]
        while cur != start:
            cycle.append(cur)
            visited.add(cur)
            # Leave through the *other* face of cur.
            f0, f1 = _EDGE_FACES[cur]
            face = f1 if face == f0 else f0
            cur = partner[(cur, face)]
        polygons.append(cycle)

    # Orient each polygon: normals must point from inside (> iso) to outside.
    oriented = []
    for cyc in polygons:
        mids = np.array(
            [
                EDGE_BASE_OFFSET[e].astype(np.float64)
                + 0.5 * np.eye(3)[EDGE_AXIS[e]]
                for e in cyc
            ]
        )
        # Newell normal of the (possibly non-planar) polygon.
        n = np.zeros(3)
        for i in range(len(cyc)):
            a = mids[i]
            b = mids[(i + 1) % len(cyc)]
            n += np.cross(a, b)
        # Average inside->outside direction over the cycle's edges.
        score = 0.0
        for e in cyc:
            c0, c1 = _EDGE_CORNERS[e]
            d = _CORNER_OFFSETS[c1].astype(np.float64) - _CORNER_OFFSETS[c0].astype(
                np.float64
            )
            if inside[c0]:  # c0 inside, c1 outside: outward is +d
                score += np.dot(n, d)
            else:
                score -= np.dot(n, d)
        if score < 0:
            cyc = cyc[::-1]
        oriented.append(cyc)
    return oriented


def _generate_tables():
    max_tris = 0
    all_tris = []
    for case in range(256):
        tris = []
        for cyc in _case_polygons(case):
            for i in range(1, len(cyc) - 1):
                tris.append((cyc[0], cyc[i], cyc[i + 1]))
        all_tris.append(tris)
        max_tris = max(max_tris, len(tris))

    tri_table = np.full((256, max_tris, 3), -1, dtype=np.int8)
    tri_count = np.zeros(256, dtype=np.int8)
    for case, tris in enumerate(all_tris):
        tri_count[case] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri
    return tri_table, tri_count


TRI_TABLE, TRI_COUNT = _generate_tables()
MAX_TRIANGLES_PER_CELL = TRI_TABLE.shape[1]
