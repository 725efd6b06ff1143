"""One frame's surface reconstruction in plain PyTorch: the reference.

Follows the published method of splashsurf (its README and
``splashsurf_lib``), written here from the equations and not from the
program:

- SPH densities with the cubic spline of compact support h:
  rho_i = m * sum_j W(|x_i - x_j|, h), the particle itself included, with
  W(r) = 8 / h^3 * ((2 - q)_+^3 - 4 (1 - q)_+^3) / (4 pi), q = 2 r / h, and
  m = (2 r_p)^3 * rest density;
- the background grid: the particles' AABB grown by the particle radius and
  then by the kernel evaluation radius (cube size * ceil(h / cube size) *
  (1 + sqrt(float32 eps))), its minimum aligned down to a multiple of the
  cube size, the cell counts rounded up;
- the level set at every grid point: phi(p) = sum_j (m / rho_j) W(|p - x_j|, h);
- marching cubes: a point is inside iff phi >= iso; one vertex on each grid
  edge whose end points differ, at t = (iso - phi_0) / (phi_1 - phi_0) along
  it; triangles from the case table of ``mc_table``.

Everything runs on the positions' device, in blocks bounded by ``elems``
elements and in x-slabs of the grid bounded by ``slab_points`` points, so
that a 13M-particle frame fits beside nothing else. ``Precision`` says in
which types the work is done: float64 throughout for the reference, a
lower type for the control.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from reference import mc_table

FOUR_PI = 4.0 * math.pi


@dataclasses.dataclass(frozen=True)
class Precision:
    """``work``: positions, distances and grid coordinates; ``compute``:
    kernel values, sums, densities, the level set and the edge parameters;
    ``out``: the vertex coordinates of a mesh that is handed out."""

    work: torch.dtype
    compute: torch.dtype
    out: torch.dtype


REFERENCE = Precision(torch.float64, torch.float64, torch.float64)


@dataclasses.dataclass(frozen=True)
class Params:
    particle_radius: float
    compact_support_radius: float
    cube_size: float
    iso: float
    rest_density: float

    @property
    def mass(self) -> float:
        return (2.0 * self.particle_radius) ** 3 * self.rest_density

    @staticmethod
    def from_config(cfg: dict) -> "Params":
        """From a configuration's parameters in the CLI's terms: the
        particle radius, the smoothing length and cube size relative to it
        (compact support = 2 * smoothing length), the iso value and the
        rest density."""
        r = float(cfg["particle_radius"])
        return Params(
            particle_radius=r,
            compact_support_radius=2.0 * float(cfg["smoothing_length"]) * r,
            cube_size=float(cfg["cube_size"]) * r,
            iso=float(cfg["iso_surface_threshold"]),
            rest_density=float(cfg["rest_density"]),
        )


@dataclasses.dataclass(frozen=True)
class Grid:
    min: tuple
    cell_size: float
    n_cells: tuple

    @property
    def n_points(self) -> tuple:
        return tuple(c + 1 for c in self.n_cells)


def cubic_w(r: torch.Tensor, h: float) -> torch.Tensor:
    """The cubic spline W(r) with compact support h, in r's type."""
    q = r * (2.0 / h)
    a = torch.clamp_min(2.0 - q, 0.0)
    b = torch.clamp_min(1.0 - q, 0.0)
    return (a * a * a - 4.0 * (b * b * b)) * (8.0 / h**3 / FOUR_PI)


def neighbour_pairs(x: torch.Tensor, h: float, elems: int = 1 << 25):
    """Candidate pairs of the positions ``x``: for each block of particles
    [s, s + len) and each of the 27 bins of side h around a particle's own,
    yields (s, qi, j): the rows qi within the block and the particles j in
    that bin, so that every pair closer than h comes once. A block's pairs
    per bin offset stay within ``elems``."""
    lo = x.min(0).values
    ijk = torch.floor((x - lo) / h).long() + 1  # one empty bin of padding each side
    dims = (ijk.max(0).values + 2).tolist()
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = torch.argsort(key)
    counts = torch.bincount(key, minlength=dims[0] * dims[1] * dims[2])
    starts = torch.cumsum(counts, 0) - counts
    offsets = [(a * dims[1] + b) * dims[2] + c
               for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    n = x.shape[0]
    block = max(1, elems // max(1, int(counts.max())))
    for s in range(0, n, block):
        e = min(n, s + block)
        for o in offsets:
            nb = key[s:e] + o
            c = counts[nb]
            tot = int(c.sum())
            if tot == 0:
                continue
            qi = torch.repeat_interleave(torch.arange(e - s, device=x.device), c,
                                         output_size=tot)
            first = torch.cumsum(c, 0) - c
            yield s, qi, order[starts[nb][qi] + torch.arange(tot, device=x.device) - first[qi]]


def densities(pos: torch.Tensor, p: Params, prec: Precision = REFERENCE,
              elems: int = 1 << 25) -> torch.Tensor:
    """Every particle's density, (N,) in ``prec.compute``: the kernel
    summed over all pairs within h (``neighbour_pairs``)."""
    x = pos.to(prec.work)
    h = p.compact_support_radius
    rho = torch.zeros(x.shape[0], dtype=prec.compute, device=x.device)
    for s, qi, j in neighbour_pairs(x, h, elems):
        r = torch.linalg.vector_norm(x[s + qi] - x[j], dim=1).to(prec.compute)
        rho.index_add_(0, s + qi, cubic_w(r, h))
    return rho * p.mass


def grid_for(pos: torch.Tensor, p: Params) -> Grid:
    """The background grid of these positions (the published rule, in
    float64 on the host from the positions' exact extremes)."""
    lo, hi = torch.aminmax(pos, dim=0)
    mins = lo.double().cpu().numpy() - p.particle_radius
    maxs = hi.double().cpu().numpy() + p.particle_radius
    cs = p.cube_size
    hsc = math.ceil(p.compact_support_radius / cs)
    ker = cs * hsc * (1.0 + math.sqrt(float(np.finfo(np.float32).eps)))
    mins, maxs = mins - ker, maxs + ker
    gmin = np.floor(mins / cs) * cs
    nc = np.maximum(np.ceil((maxs - gmin) / cs).astype(np.int64), 1)
    return Grid(tuple(float(v) for v in gmin), float(cs), tuple(int(c) for c in nc))


def _support_span(p: Params) -> tuple:
    """(rs, M): the support radius in cells, and the points per axis that
    can lie within it of a particle, from ceil(g - rs)."""
    rs = p.compact_support_radius / p.cube_size
    return rs, int(math.floor(2.0 * rs)) + 1


class SlabPass:
    """The level set of one frame on the grid, x-slab by x-slab.

    ``run(visit)`` computes each slab's values on the point planes
    [px0, own1 + 1) (the last plane of the grid at most) and calls
    ``visit(values, px0, own1)``, where the slab owns the planes
    [px0, own1). Slabs run in ascending x; a slab's first plane is its
    predecessor's last plane, bit for bit, so every plane has one value."""

    def __init__(self, pos: torch.Tensor, weights: torch.Tensor, grid: Grid, p: Params,
                 prec: Precision = REFERENCE, elems: int = 1 << 24,
                 slab_points: int = 1 << 26):
        self.prec, self.grid, self.p, self.elems = prec, grid, p, elems
        x = pos.to(prec.work)
        dev = x.device
        self.gmin = torch.tensor(grid.min, dtype=prec.work, device=dev)
        rs, self.M = _support_span(p)
        g = (x - self.gmin) / grid.cell_size
        base = torch.ceil(g - rs).long()
        order = torch.argsort(base[:, 0])
        self.x, self.base, self.w = x[order], base[order], weights[order].to(prec.compute)
        self.bx = self.base[:, 0].contiguous()
        m = self.M
        r = torch.arange(m, device=dev)
        self.offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        npx, npy, npz = grid.n_points
        self.width = max(1, min(npx, slab_points // (npy * npz) - 1))

    def _values(self, px0: int, px1: int) -> torch.Tensor:
        npx, npy, npz = self.grid.n_points
        dev, prec, m = self.x.device, self.prec, self.M
        acc = torch.zeros((px1 - px0) * npy * npz, dtype=prec.compute, device=dev)
        lo = int(torch.searchsorted(self.bx, torch.tensor(px0 - m + 1, device=dev)))
        hi = int(torch.searchsorted(self.bx, torch.tensor(px1, device=dev)))
        block = max(1, self.elems // self.offs.shape[0])
        h, cs = self.p.compact_support_radius, self.grid.cell_size
        top = torch.tensor([px1, npy, npz], device=dev)
        for s in range(lo, hi, block):
            e = min(hi, s + block)
            pts = self.base[s:e, None, :] + self.offs[None]
            ok = ((pts >= 0).all(-1) & (pts < top).all(-1) & (pts[..., 0] >= px0))
            pts, which = pts[ok], ok.nonzero()[:, 0] + s
            coord = self.gmin + pts.to(prec.work) * cs
            r = torch.linalg.vector_norm(coord - self.x[which], dim=1).to(prec.compute)
            flat = ((pts[:, 0] - px0) * npy + pts[:, 1]) * npz + pts[:, 2]
            acc.index_add_(0, flat, cubic_w(r, h) * self.w[which])
        return acc.reshape(px1 - px0, npy, npz)

    def run(self, visit: Callable) -> None:
        npx = self.grid.n_points[0]
        plane = None
        for px0 in range(0, npx, self.width):
            own1 = min(npx, px0 + self.width)
            vals = self._values(px0, min(npx, own1 + 1))
            if plane is not None:
                vals[0] = plane
            plane = vals[-1].clone()
            visit(vals, px0, own1)


@dataclasses.dataclass
class SlabMesh:
    """Marching cubes of one slab: its owned vertices (global edge keys and
    positions) and its owned cells' triangles (as triples of edge keys),
    with their area and signed volume in float64."""

    keys: torch.Tensor
    verts: torch.Tensor
    tri_keys: Optional[torch.Tensor]
    n_tris: int
    area: float
    volume: float


def _tables(dev):
    count = torch.as_tensor(mc_table.TRI_COUNT.astype(np.int64), device=dev)
    table = torch.as_tensor(np.where(mc_table.TRI_TABLE >= 0, mc_table.TRI_TABLE, 0)
                            .astype(np.int64), device=dev)
    axis = torch.as_tensor(mc_table.EDGE_AXIS.astype(np.int64), device=dev)
    base = torch.as_tensor(mc_table.EDGE_BASE_OFFSET.astype(np.int64), device=dev)
    return count, table, axis, base


def _edge_points(vals: torch.Tensor, ijk: torch.Tensor, axis: torch.Tensor, px0: int,
                 grid: Grid, iso: float, prec: Precision) -> torch.Tensor:
    """Positions (in ``prec.out``) of the vertices on the edges from local
    point ``ijk`` along ``axis``: one interpolation, in ``prec.compute``."""
    step = torch.nn.functional.one_hot(axis, 3)
    b = ijk + step
    v0 = vals[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
    v1 = vals[b[:, 0], b[:, 1], b[:, 2]]
    t = torch.clamp((iso - v0) / (v1 - v0), 0.0, 1.0)
    gmin = torch.tensor(grid.min, dtype=prec.out, device=vals.device)
    glob = ijk + torch.tensor([px0, 0, 0], device=vals.device)
    pos = gmin + glob.to(prec.out) * grid.cell_size
    return pos + step.to(prec.out) * (t.to(prec.out) * grid.cell_size)[:, None]


def slab_mesh(vals: torch.Tensor, px0: int, own1: int, grid: Grid, iso: float,
              prec: Precision = REFERENCE, want_tris: bool = False) -> SlabMesh:
    """Marching cubes of the slab whose values ``vals`` cover the point
    planes [px0, px0 + len(vals)) and which owns the planes [px0, own1)."""
    dev = vals.device
    npx, npy, npz = grid.n_points
    n_pts = npx * npy * npz
    inside = vals >= iso
    nown = own1 - px0
    keys, verts = [], []
    for a in range(3):
        nx = min(own1, npx - 1) - px0 if a == 0 else nown
        lim = [nx, npy, npz]
        lim[a] = lim[a] - 1 if a else lim[a]
        if min(lim) <= 0:
            continue
        sl0 = inside[: lim[0], : lim[1], : lim[2]]
        o = [0, 0, 0]
        o[a] = 1
        sl1 = inside[o[0]: o[0] + lim[0], o[1]: o[1] + lim[1], o[2]: o[2] + lim[2]]
        ijk = torch.nonzero(sl0 != sl1)
        verts.append(_edge_points(vals, ijk, torch.full_like(ijk[:, 0], a), px0, grid,
                                  iso, prec))
        keys.append(a * n_pts + ((ijk[:, 0] + px0) * npy + ijk[:, 1]) * npz + ijk[:, 2])
    keys = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.long, device=dev)
    verts = (torch.cat(verts) if verts
             else torch.zeros((0, 3), dtype=prec.out, device=dev))

    count, table, eaxis, ebase = _tables(dev)
    ncx = min(own1, npx - 1) - px0
    area = volume = 0.0
    tri_keys, n_tris = None, 0
    if ncx > 0:
        case = torch.zeros((ncx, npy - 1, npz - 1), dtype=torch.long, device=dev)
        for c in range(8):
            oi, oj, ok = (c >> 2) & 1, (c >> 1) & 1, c & 1
            case |= inside[oi: oi + ncx, oj: oj + npy - 1, ok: ok + npz - 1].long() << c
        case = case.reshape(-1)
        cnt = count[case]
        cells = torch.nonzero(cnt).squeeze(1)
        ccnt = cnt[cells]
        n_tris = int(ccnt.sum())
        if n_tris:
            tri_cell = torch.repeat_interleave(cells, ccnt, output_size=n_tris)
            first = torch.cumsum(ccnt, 0) - ccnt
            slot = (torch.arange(n_tris, device=dev)
                    - torch.repeat_interleave(first, ccnt, output_size=n_tris))
            cy, cz = npy - 1, npz - 1
            cell = torch.stack([tri_cell // (cy * cz), (tri_cell // cz) % cy, tri_cell % cz], 1)
            tcase = case[tri_cell]
            corners, ckeys = [], []
            for k in range(3):
                e = table[tcase, slot, k]
                ijk = cell + ebase[e]
                corners.append(_edge_points(vals, ijk, eaxis[e], px0, grid, iso, prec)
                               .double())
                if want_tris:
                    ckeys.append(eaxis[e] * n_pts
                                 + ((ijk[:, 0] + px0) * npy + ijk[:, 1]) * npz + ijk[:, 2])
            a0, b0, c0 = corners
            cross = torch.linalg.cross(b0 - a0, c0 - a0)
            area = 0.5 * float(torch.linalg.vector_norm(cross, dim=1).sum())
            volume = float((a0 * cross).sum()) / 6.0
            if want_tris:
                tri_keys = torch.stack(ckeys, 1)
    return SlabMesh(keys, verts, tri_keys, n_tris, area, volume)


def mesh_totals(vertices: torch.Tensor, triangles: torch.Tensor) -> tuple:
    """(area, signed volume) of an indexed triangle mesh, in float64."""
    v = vertices.double()
    t = triangles.long()
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    cross = torch.linalg.cross(b - a, c - a)
    return (0.5 * float(torch.linalg.vector_norm(cross, dim=1).sum()),
            float((a * cross).sum()) / 6.0)
