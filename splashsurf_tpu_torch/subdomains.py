"""Subdomain-grid reconstruction (PyTorch port of the resident,
single-device route of ``splashsurf_tpu.subdomains``; reference
dense_subdomains.rs).

The background grid is tiled into cubic subdomains of ``n_sub``^3 cells.
Only subdomains that hold particles, their own or ghosts within the
margin, get a level set: a (P, P, P) block of point values, P = n_sub + 1.

  1. densities on the whole particle set (``neighbors``; sparse scenes take
     the binned formulation);
  2. ``decompose``: (subdomain, particle) pairs with ghost margins, sorted
     by (subdomain, raster cell, particle id), each with its rank in its
     raster cell;
  3. per chunk of subdomains, ``chunk_levelset_raster``: two-slot rasters
     swept by kernel K3, plus a scatter splat of the particles that found
     both slots of their cell taken;
  4. ``halo_overwrite``: every point shared by several subdomains takes the
     value of the one with the smallest id;
  5. ``chunk_mc``: marching cubes per chunk of subdomains, each vertex keyed
     by its global edge;
  6. ``stitch``: one sort-unique over the global edge keys merges the
     vertices that neighbouring subdomains both emit.

Eager PyTorch reads counts back where it needs them, so the pair list and
the overflow lists have their exact sizes: the reference's capacity retries,
jit shape buckets and overflow caps have no counterpart here. Chunks follow
ascending occupancy and are bounded by a byte budget; every subdomain's
result is independent of the chunk it lands in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.density import supported_point_offsets
from splashsurf_tpu_torch.mc.dense import _local_edge_coeffs, edge_layout, lut_tensors
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.neighbors import compute_particle_densities
from splashsurf_tpu_torch.ops.global_sweep import check_empty_field
from splashsurf_tpu_torch.ops.splat_kernels import splat_sweep_cuda
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# Largest resident level-set store, (B + 1) * P^3 * itemsize bytes (the
# reference's own measure). Half of the 80 GB card: the other half holds
# what lives beside it at the peak, which is the particle side (positions,
# densities and the int64 pair arrays, about 0.3 KB per particle: 2.5 GB at
# 8M particles), one chunk's working set (at most CHUNK_BYTES, or twice it
# while a chunk's level sets are copied into the store) and the caching
# allocator's slack. Past it the reference streams level sets chunk by
# chunk, which is not ported yet (ROADMAP.md, queue 1).
RESIDENT_LS_BYTES = 40 * 10**9

# Working-set budget of one splat, halo or marching-cubes chunk.
CHUNK_BYTES = 1 << 30

# Raster slots per cell: a pair of rank >= SLOTS in its raster cell goes
# through the scatter splat.
SLOTS = 2

_ABSENT = torch.iinfo(torch.int64).max  # no neighbour subdomain

# Facts about the last run, read by tests and chip_smoke.py, never by the
# pipeline (the reference keeps the same record): occupied subdomains "B",
# resident level-set bytes "ls_bytes", pair and chunk counts, and
# "stage_s", the seconds of each stage.
LAST_RUN: dict = {}


@dataclasses.dataclass(frozen=True)
class SubdomainGridParams:
    """Derived decomposition parameters (dense_subdomains.rs:89-244)."""

    global_grid: UniformGrid  # padded so cells are a multiple of n_sub
    subdomain_grid: UniformGrid  # one cell per subdomain
    n_sub: int  # MC cells per subdomain per dim
    margin_cells: int  # ghost margin in MC cells (= half supported cells)

    @property
    def num_subdomains(self) -> Tuple[int, int, int]:
        return self.subdomain_grid.n_cells

    @property
    def points_per_dim(self) -> int:
        return self.n_sub + 1


def initialize_parameters(parameters: Parameters, grid: UniformGrid) -> SubdomainGridParams:
    n_sub = parameters.grid_decomposition.subdomain_num_cubes_per_dim
    ext = kernel_extents(parameters.compact_support_radius, parameters.cube_size)
    num_sub = tuple(-(-c // n_sub) for c in grid.n_cells)
    return SubdomainGridParams(
        global_grid=UniformGrid(
            min=grid.min, cell_size=grid.cell_size,
            n_cells=tuple(n * n_sub for n in num_sub),
        ),
        subdomain_grid=UniformGrid(
            min=grid.min, cell_size=grid.cell_size * n_sub, n_cells=num_sub
        ),
        n_sub=n_sub,
        margin_cells=ext.half_supported_cells,
    )


# ---------------------------------------------------------------------------
# decomposition: (subdomain, particle) pairs with ghost margins
# ---------------------------------------------------------------------------

_OFFSETS27 = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int64,
)
_BITS8 = np.array([((b >> 2) & 1, (b >> 1) & 1, b & 1) for b in range(8)], np.int64)


def decompose(positions: torch.Tensor, sd: SubdomainGridParams):
    """Expand particles into (subdomain, particle) pairs with ghost margins
    (the GhostMarginClassifier, dense_subdomains.rs:1751-1906): a particle
    belongs to its own subdomain and to every neighbour whose raster, the
    subdomain's cells plus ``margin_cells`` on each side, contains its cell.

    Returns int64 (n_pairs,) tensors (targets, particle ids, raster cells,
    ranks), sorted by (target, raster cell, particle id): target is the flat
    subdomain id, raster cell the flat index in the (R, R, R) raster, R =
    n_sub + 2 * margin, and rank the position within its raster cell. The
    expansion table is laid out particle-major, so its compaction lists
    particle ids in ascending order and one stable sort on the combined
    (target, raster cell) key gives the three-key order.
    """
    dev = positions.device
    g = sd.global_grid
    n_sub, m = sd.n_sub, sd.margin_cells
    R = n_sub + 2 * m
    num_sub = torch.tensor(sd.num_subdomains, device=dev)

    # particles outside the global grid keep their outside cells: within the
    # margin they are ghosts of the border subdomains, further out of none
    gc = g.enclosing_cell(positions)
    own = torch.minimum(
        torch.div(gc, n_sub, rounding_mode="floor").clamp_min(-1), num_sub
    )
    local = gc - own * n_sub
    if n_sub > 2 * m:
        # a particle lies in the margin of at most one side per axis: its
        # targets are own + {0, side}^3 (8 candidates instead of 27)
        side = torch.where(local < m, -1, torch.where(local >= n_sub - m, 1, 0))
        use = torch.as_tensor(_BITS8, device=dev)[None]  # (1, 8, 3)
        t = own[:, None] + side[:, None] * use
        cond = torch.all((side[:, None] != 0) | (use == 0), dim=-1)
    else:
        # tiny subdomains, whose margins span both sides: all 27 neighbours
        o = torch.as_tensor(_OFFSETS27, device=dev)[None]  # (1, 27, 3)
        lo = (local < m)[:, None]
        hi = (local >= n_sub - m)[:, None]
        t = own[:, None] + o
        cond = torch.all(((o != -1) | lo) & ((o != 1) | hi), dim=-1)
    cond &= torch.all((t >= 0) & (t < num_sub), dim=-1)

    pid, e = torch.nonzero(cond, as_tuple=True)  # particle-major
    ts = t[pid, e]
    target = sd.subdomain_grid.flatten_cell_index(ts)
    rc = gc[pid] - ts * n_sub + m
    cell = (rc[:, 0] * R + rc[:, 1]) * R + rc[:, 2]
    key, order = torch.sort(target * (R * R * R) + cell, stable=True)
    target, cell, pid = target[order], cell[order], pid[order]

    n_pairs = key.shape[0]
    is_start = torch.ones(n_pairs, dtype=torch.bool, device=dev)
    is_start[1:] = key[1:] != key[:-1]
    run_first = torch.nonzero(is_start).squeeze(1)
    rank = torch.arange(n_pairs, device=dev) - run_first[torch.cumsum(is_start, 0) - 1]
    return target, pid, cell, rank


def occupied_segments(targets: torch.Tensor):
    """Host (ids, starts, counts) int64 arrays of the occupied subdomains,
    ascending ids, from the sorted pair targets."""
    ids, counts = torch.unique_consecutive(targets, return_counts=True)
    ids, counts = ids.cpu().numpy(), counts.cpu().numpy()
    return ids, np.cumsum(counts) - counts, counts


def _gather_pairs(starts: torch.Tensor, counts: torch.Tensor, rows: torch.Tensor, total: int):
    """The pair indices of the subdomains ``rows`` (their sorted-pair
    segments, concatenated) and the chunk-local row of each pair."""
    cnt = counts[rows]
    row = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=rows.device), cnt, output_size=total
    )
    first = torch.cumsum(cnt, 0) - cnt
    idx = starts[rows][row] + torch.arange(total, device=rows.device) - first[row]
    return idx, row


# ---------------------------------------------------------------------------
# per-chunk level-set splat
# ---------------------------------------------------------------------------


def chunk_levelset_scatter(
    positions, values, pids, rows, sub_ijk, sd: SubdomainGridParams,
    compact_support_radius, hsc: int, out: Optional[torch.Tensor] = None,
):
    """Scatter-add splat: each listed particle (``pids``, with ``rows`` its
    chunk-local subdomain) adds v W(|x_g - x|) to the supported points of
    its subdomain's core [0, n_sub]^3; points outside belong to neighbours
    and are dropped. Returns (or adds into ``out``) the (C, P, P, P) level
    sets, C = len(sub_ijk).

    The lists are exact, so no far dummy particle (and no clip of its
    deltas) is needed. ``index_add_`` runs with atomics on CUDA: the order
    of the sums at a point, and its last bits, change from run to run."""
    dtype = positions.dtype
    dev = positions.device
    n_sub = sd.n_sub
    P = sd.points_per_dim
    C = sub_ijk.shape[0]
    if out is None:
        out = torch.zeros((C, P, P, P), dtype=dtype, device=dev)
    flat_out = out.view(-1)
    g = sd.global_grid
    px = positions[pids]
    val = values[pids]
    sub_base = sub_ijk[rows] * n_sub
    base = g.enclosing_cell(px) - sub_base
    offs = torch.as_tensor(supported_point_offsets(hsc).astype(np.int64), device=dev)
    strides = (P * P, P, 1)
    # bound the (particles, offsets) block to ~2^22 entries
    step = max(1, (1 << 22) // offs.shape[0])
    for b in range(0, pids.shape[0], step):
        sl = slice(b, b + step)
        d2 = 0.0
        flat = rows[sl, None] * (P * P * P)
        valid = True
        for d in range(3):
            pl = base[sl, d, None] + offs[None, :, d]
            coord = kernels.grid_coord(pl + sub_base[sl, d, None], g.min[d], g.cell_size, dtype)
            delta = coord - px[sl, d, None]
            d2 = d2 + delta * delta
            valid = valid & (pl >= 0) & (pl <= n_sub)
            flat = flat + pl * strides[d]
        w = kernels.cubic_kernel(torch.sqrt(d2), compact_support_radius) * val[sl, None]
        flat_out.index_add_(0, flat[valid], w[valid])
    return out


def chunk_rasters(positions, values, pids, rows, cells, ranks, C: int, sd: SubdomainGridParams):
    """The chunk's per-component (C, SLOTS, Rp, Rp, Rp) rasters, Rp = n_sub
    + 2 * margin + 2 (the ghost ring plus one empty cell per side): each
    pair (``pids`` with chunk-local ``rows``, raster ``cells`` and ``ranks``
    from ``decompose``) of rank < SLOTS writes its fraction from its
    cell corner and its weight; empty slots hold the far sentinel and
    weight 0. Returns (fx, fy, fz, fv)."""
    dtype = positions.dtype
    R = sd.n_sub + 2 * sd.margin_cells
    Rp = R + 2
    g = sd.global_grid
    px = positions[pids]
    gc = g.enclosing_cell(px)
    rc = (cells // (R * R), (cells // R) % R, cells % R)
    dest = (((rows * SLOTS + ranks) * Rp + rc[0] + 1) * Rp + rc[1] + 1) * Rp + rc[2] + 1
    total = C * SLOTS * Rp**3
    dest = torch.where(ranks < SLOTS, dest, total)
    shape = (C, SLOTS, Rp, Rp, Rp)
    far = kernels.far_fill(dtype)
    return tuple(
        kernels.scatter_table(
            dest, px[:, d] - kernels.grid_coord(gc[:, d], g.min[d], g.cell_size, dtype),
            total, far, shape,
        )
        for d in range(3)
    ) + (kernels.scatter_table(dest, values[pids], total, 0.0, shape),)


def chunk_levelset_raster(
    positions, values, pids, rows, cells, ranks, sub_ijk,
    sd: SubdomainGridParams, compact_support_radius, hsc: int,
):
    """Raster-sweep splat of a chunk of C = len(sub_ijk) subdomains: (C, P,
    P, P) level sets. Kernel K3 sums the pruned offset fan over the chunk's
    rasters (``chunk_rasters``); the pairs of rank >= SLOTS go through
    ``chunk_levelset_scatter`` into the same level sets."""
    rasters = chunk_rasters(positions, values, pids, rows, cells, ranks, sub_ijk.shape[0], sd)
    ls = splat_sweep_cuda(
        *rasters, sd.global_grid.cell_size, compact_support_radius, hsc,
        sd.margin_cells, sd.points_per_dim,
    )
    del rasters
    over = ranks >= SLOTS
    if bool(over.any()):
        chunk_levelset_scatter(
            positions, values, pids[over], rows[over], sub_ijk, sd,
            compact_support_radius, hsc, out=ls,
        )
    return ls


# ---------------------------------------------------------------------------
# canonical halo overwrite
# ---------------------------------------------------------------------------

_DIRS26 = np.array([o for o in _OFFSETS27 if not (o == 0).all()], dtype=np.int64)


def _region(c: int, P: int) -> slice:
    return slice(P - 1, P) if c == 1 else slice(0, 1) if c == -1 else slice(None)


def _mirror(c: int, P: int) -> slice:
    return _region(-c, P)


def _neighbor_tables(occ_ids: np.ndarray, sub_ijk: np.ndarray, sd: SubdomainGridParams):
    """(26, B) int64 host tables: the batch index of each subdomain's
    neighbour in each direction of ``_DIRS26`` (0 if absent) and its flat id
    (``_ABSENT`` if absent)."""
    ns = np.asarray(sd.num_subdomains)
    B = len(occ_ids)
    nb_idx = np.zeros((26, B), np.int64)
    nb_flat = np.full((26, B), _ABSENT, np.int64)
    for d, o in enumerate(_DIRS26):
        t = sub_ijk + o[None, :]
        valid = np.all((t >= 0) & (t < ns), axis=1)
        tflat = (t[:, 0] * ns[1] + t[:, 1]) * ns[2] + t[:, 2]
        pos = np.clip(np.searchsorted(occ_ids, tflat), 0, B - 1)
        present = valid & (occ_ids[pos] == tflat)
        nb_idx[d] = np.where(present, pos, 0)
        nb_flat[d] = np.where(present, tflat, _ABSENT)
    return nb_idx, nb_flat


def halo_overwrite(ls, own_flat, nb_idx, nb_flat, chunk: Optional[int] = None):
    """Make every shared boundary point take the value of the smallest-id
    subdomain that holds it, in place on ``ls`` (B, P, P, P); ``own_flat``
    (B,) are the subdomains' flat ids, ``nb_idx`` / ``nb_flat`` (26, B) the
    neighbour tables. The 26 directions go in the reference's order with its
    min-id tracking, ``chunk`` subdomains at a time.

    The reference reads candidates from the level sets before the pass; this
    pass reads them in place. The result is the same, bit for bit: a value
    stored at a point is always the original value of some subdomain that
    holds the point and has an id no larger than the holder's, so the
    smallest-id holder's value never changes, and it is what every holder
    ends with."""
    B, P = ls.shape[0], ls.shape[1]
    step = B if chunk is None else max(1, chunk)
    for b0 in range(0, B, step):
        b1 = min(b0 + step, B)
        best = own_flat[b0:b1, None, None, None].expand(-1, P, P, P).clone()
        for d, o in enumerate(_DIRS26):
            reg = tuple(_region(int(c), P) for c in o)
            mir = tuple(_mirror(int(c), P) for c in o)
            cand_val = ls[(nb_idx[d, b0:b1],) + mir]
            cand_flat = nb_flat[d, b0:b1, None, None, None]
            own = ls[(slice(b0, b1),) + reg]
            cur = best[(slice(None),) + reg]
            take = cand_flat < cur
            ls[(slice(b0, b1),) + reg] = torch.where(take, cand_val, own)
            best[(slice(None),) + reg] = torch.where(take, cand_flat, cur)
    return ls


# ---------------------------------------------------------------------------
# batched marching cubes and stitching
# ---------------------------------------------------------------------------


def chunk_mc(ls, sub_ijk, sd: SubdomainGridParams, iso):
    """Marching cubes over the (C, P, P, P) level sets of a chunk, the batch
    folded into the flat edge and cell index spaces.

    Returns (vertices (V, 3), keys (V,), triangles (T, 3)): one vertex per
    active edge in (subdomain, x/y/z edge array, base point) order, keyed by
    its global edge ((i * npy + j) * npz + k) * 3 + axis, and triangles in
    (subdomain, cell, case-table slot) order with chunk-local vertex
    indices. Edges on a face shared with a neighbour come out of both; the
    stitch merges them.
    """
    dtype, dev = ls.dtype, ls.device
    C, P = ls.shape[0], ls.shape[1]
    g = sd.global_grid
    _, npy, npz = g.n_points
    iso = kernels.rounded(iso, dtype)
    cs = kernels.rounded(g.cell_size, dtype)
    inside = ls >= iso

    masks = []
    for a in range(3):
        lo = (slice(None),) + tuple(slice(0, -1) if d == a else slice(None) for d in range(3))
        hi = (slice(None),) + tuple(slice(1, None) if d == a else slice(None) for d in range(3))
        masks.append((inside[lo] != inside[hi]).reshape(C, -1))
    mask = torch.cat(masks, dim=1).reshape(-1)
    shapes, _, axoffs, e_local = edge_layout((P, P, P))
    vidx = torch.cumsum(mask, 0) - 1

    # vertices on the active edges
    active = torch.nonzero(mask).squeeze(1)
    row = active // e_local
    le = active % e_local
    axis = (le >= axoffs[1]).long() + (le >= axoffs[2]).long()
    rem = le - torch.as_tensor(axoffs, device=dev)[axis]
    sy = torch.as_tensor([s[1] for s in shapes], device=dev)[axis]
    sz = torch.as_tensor([s[2] for s in shapes], device=dev)[axis]
    ijk = (rem // (sy * sz), (rem // sz) % sy, rem % sz)
    p0 = row * (P * P * P) + (ijk[0] * P + ijk[1]) * P + ijk[2]
    step = torch.where(axis == 0, P * P, torch.where(axis == 1, P, 1))
    ls_flat = ls.reshape(-1)
    v0 = ls_flat[p0]
    denom = ls_flat[p0 + step] - v0
    t = torch.clamp(
        (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
    )
    gijk = [ijk[d] + sub_ijk[row, d] * sd.n_sub for d in range(3)]
    vertices = torch.stack(
        [
            kernels.grid_coord(gijk[d], g.min[d], cs, dtype) + torch.where(axis == d, t, 0.0) * cs
            for d in range(3)
        ],
        dim=1,
    )
    keys = ((gijk[0] * npy + gijk[1]) * npz + gijk[2]) * 3 + axis

    # triangles of the active cells
    n = P - 1
    case = torch.zeros((C, n, n, n), dtype=torch.int64, device=dev)
    for c8 in range(8):
        oi, oj, ok = (c8 >> 2) & 1, (c8 >> 1) & 1, c8 & 1
        case |= inside[:, oi : oi + n, oj : oj + n, ok : ok + n].long() << c8
    count_t, tab_t = lut_tensors(dev)
    case = case.reshape(-1)
    counts = count_t[case]
    cells = torch.nonzero(counts).squeeze(1)
    ccounts = counts[cells]
    n_tris = int(ccounts.sum())
    tri_cell = torch.repeat_interleave(cells, ccounts, output_size=n_tris)
    starts = torch.cumsum(ccounts, 0) - ccounts
    slot = torch.arange(n_tris, device=dev) - torch.repeat_interleave(
        starts, ccounts, output_size=n_tris
    )
    trow, cl = tri_cell // (n * n * n), tri_cell % (n * n * n)
    ci, cj, ck = cl // (n * n), (cl // n) % n, cl % n
    coeffs = [torch.as_tensor(c, device=dev) for c in _local_edge_coeffs((P, P, P))]
    tcase = case[tri_cell]
    cols = []
    for corner in range(3):
        local = tab_t[tcase, slot, corner]
        edge = (
            trow * e_local + coeffs[0][local] + coeffs[1][local] * ci
            + coeffs[2][local] * cj + coeffs[3][local] * ck
        )
        cols.append(vidx[edge])
    return vertices, keys, torch.stack(cols, dim=1)


def stitch(vertices: List[torch.Tensor], keys: List[torch.Tensor], triangles: List[torch.Tensor]):
    """Merge the chunks' patches (dense_subdomains.rs:1603-1749): one
    sort-unique over the global edge keys. Vertices come out in ascending
    key order; an edge emitted by two subdomains has bit-identical vertices
    in both (the halo overwrite equalised their shared level-set values),
    so either copy serves. Triangles keep their order, remapped."""
    offs = np.cumsum([0] + [v.shape[0] for v in vertices[:-1]])
    keys = torch.cat(keys)
    tris = torch.cat([t + int(o) for t, o in zip(triangles, offs)])
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    out = torch.empty((uniq.shape[0], 3), dtype=vertices[0].dtype, device=keys.device)
    out[inverse] = torch.cat(vertices)
    return out, inverse[tris].to(torch.int32)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _chunks(order: np.ndarray, per_row: np.ndarray, budget: int) -> List[np.ndarray]:
    """Cut ``order`` into consecutive chunks whose summed ``per_row`` bytes
    stay within ``budget`` (at least one row per chunk)."""
    out, start, acc = [], 0, 0
    for i, r in enumerate(order):
        if i > start and acc + per_row[r] > budget:
            out.append(order[start:i])
            start, acc = i, 0
        acc += per_row[r]
    if len(order):
        out.append(order[start:])
    return out


def splat_plan(counts: np.ndarray, sd: SubdomainGridParams, itemsize: int, chunk_bytes: int):
    """The splat's chunks: occupied-subdomain rows in ascending occupancy,
    cut so that each chunk's rasters, level sets and pair arrays stay
    within ``chunk_bytes``."""
    Rp = sd.n_sub + 2 * sd.margin_cells + 2
    per_sub = (4 * SLOTS * Rp**3 + sd.points_per_dim**3) * itemsize  # 4 rasters, level set
    return _chunks(np.argsort(counts, kind="stable"), per_sub + 64 * counts, chunk_bytes)


class _StageClock:
    """Seconds per stage, the device synchronised at each boundary (the
    stages read counts back to the host anyway, so the few extra waits
    cost next to nothing)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times = {}
        self.t = self._now()

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str):
        now = self._now()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        self.t = now


def reconstruct_surface_subdomain_grid(
    positions: torch.Tensor,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    chunk_bytes: int = CHUNK_BYTES,
):
    """Subdomain-grid reconstruction on the positions' device, one device,
    every level set resident (reference subdomains.py:1885, its
    single-device resident branch). The mesh comes back to the host; the
    per-particle densities stay a device tensor. ``chunk_bytes`` bounds each
    chunk's working set; the result does not depend on it."""
    from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction

    dev = positions.device
    dtype = positions.dtype
    itemsize = torch.finfo(dtype).bits // 8
    sd = initialize_parameters(parameters, grid)
    h = parameters.compact_support_radius
    hsc = sd.margin_cells
    iso = parameters.iso_surface_threshold
    P = sd.points_per_dim
    LAST_RUN.clear()
    clock = _StageClock(dev)

    rho = compute_particle_densities(positions, h, parameters.particle_rest_mass)
    values = kernels.rounded(parameters.particle_rest_mass, dtype) / rho
    clock.lap("densities")

    targets, pids, cells, ranks = decompose(positions, sd)
    occ_ids, starts, counts = occupied_segments(targets)
    del targets
    B = len(occ_ids)
    ls_bytes = (B + 1) * P**3 * itemsize
    LAST_RUN.update(B=B, ls_bytes=ls_bytes, n_pairs=int(pids.shape[0]),
                    n_subdomains=sd.num_subdomains, stage_s=clock.times)
    clock.lap("decomposition")

    def result(mesh):
        return SurfaceReconstruction(
            grid=sd.global_grid, subdomain_grid=sd.subdomain_grid, mesh=mesh,
            particle_densities=rho, particle_inside_aabb=particle_inside_aabb,
        )

    if B == 0:
        return result(TriMesh3d(np.zeros((0, 3), kernels.np_dtype(dtype)), np.zeros((0, 3), np.int32)))
    if ls_bytes > RESIDENT_LS_BYTES:
        raise NotImplementedError(
            f"{B} occupied subdomains need {ls_bytes} bytes of resident level "
            f"sets, past the {RESIDENT_LS_BYTES}-byte budget: the streaming "
            "mode of the subdomain route is not ported yet (ROADMAP.md, queue 1)"
        )

    ns = sd.num_subdomains
    sub_ijk_np = np.stack(
        [occ_ids // (ns[1] * ns[2]), (occ_ids // ns[2]) % ns[1], occ_ids % ns[2]], axis=1
    )
    sub_ijk = torch.as_tensor(sub_ijk_np, device=dev)
    starts_d = torch.as_tensor(starts, device=dev)
    counts_d = torch.as_tensor(counts, device=dev)

    # level sets, chunk by chunk in ascending occupancy
    ls_all = torch.empty((B, P, P, P), dtype=dtype, device=dev)
    plan = splat_plan(counts, sd, itemsize, chunk_bytes)
    for rows_np in plan:
        rows = torch.as_tensor(rows_np, device=dev)
        idx, row = _gather_pairs(starts_d, counts_d, rows, int(counts[rows_np].sum()))
        ls_all[rows] = chunk_levelset_raster(
            positions, values, pids[idx], row, cells[idx], ranks[idx],
            sub_ijk[rows], sd, h, hsc,
        )
    del pids, cells, ranks
    LAST_RUN["splat_chunks"] = len(plan)
    clock.lap("splat")

    nb_idx, nb_flat = _neighbor_tables(occ_ids, sub_ijk_np, sd)
    halo_overwrite(
        ls_all, torch.as_tensor(occ_ids, device=dev),
        torch.as_tensor(nb_idx, device=dev), torch.as_tensor(nb_flat, device=dev),
        chunk=max(1, chunk_bytes // (8 * P**3)),
    )
    clock.lap("halo")

    # marching cubes in ascending subdomain id, so that the triangle order
    # does not depend on the chunking either
    mc_rows = max(1, chunk_bytes // (48 * P**3))
    verts, keys, tris = [], [], []
    for b0 in range(0, B, mc_rows):
        v, k, t = chunk_mc(ls_all[b0 : b0 + mc_rows], sub_ijk[b0 : b0 + mc_rows], sd, iso)
        verts.append(v)
        keys.append(k)
        tris.append(t)
    clock.lap("marching cubes")

    if sum(t.shape[0] for t in tris) == 0:
        check_empty_field(0, float(ls_all.max()), float(iso))
        mesh = TriMesh3d(np.zeros((0, 3), kernels.np_dtype(dtype)), np.zeros((0, 3), np.int32))
    else:
        del ls_all
        v, t = stitch(verts, keys, tris)
        mesh = TriMesh3d(vertices=v.cpu().numpy(), triangles=t.cpu().numpy())
    clock.lap("stitch")
    return result(mesh)
