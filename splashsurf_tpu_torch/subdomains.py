"""Subdomain-grid reconstruction (PyTorch port of
``splashsurf_tpu.subdomains``: resident, streamed and sharded; reference
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
  4. the halo: every point shared by several subdomains takes the value of
     the one with the smallest id, read by ``halo_from_shells`` from a
     (6, B, P * P) table of the subdomains' raw boundary faces
     (``halo_overwrite``, the reference's in-place pass, is what it is held
     against);
  5. ``chunk_mc``: marching cubes per chunk of subdomains, each vertex keyed
     by its global edge;
  6. ``stitch``: one sort-unique over the global edge keys merges the
     vertices that neighbouring subdomains both emit.

With ``SPLASHSURF_TPU_SUB_ENCODED_PULL=1`` (the reference's default; the
port's is the stitch) steps 5-6 are the encoded pull instead: each
subdomain emits the words and edge parameters of the points it owns
(``chunk_mc_encode``), the streams come to the host in one copy in the
reference's run order, and the host decodes the mesh (``mc_decode_sub``),
with no duplicate vertex to merge (``use_encoded_pull``).

Eager PyTorch reads counts back where it needs them, so the pair list and
the overflow lists have their exact sizes: the reference's capacity retries,
jit shape buckets and overflow caps have no counterpart here. Every
subdomain's result is independent of the chunk it lands in.

Two modes, chosen per call by the reference's switches (``use_stream``):

  * resident: every level set is kept in a (B, P, P, P) store; the splat
    runs in chunks of ascending occupancy, then the halo from the faces of
    the whole store and marching cubes in ascending id. It is the sharded
    route's per-device step (``parallel.mesh``) on one device;
  * streamed: no store. Chunks of subdomains run in ascending id, each
    splatted, its raw (pre-halo) boundary faces written into a (6, B, P*P)
    shell table, its halo taken from that table (``halo_from_shells``) and
    its marching cubes run before the next chunk. In ascending-id order
    every donor of a point (a holder with a smaller id) has its faces in
    the table before the receiver's halo reads them, same-chunk donors
    included, since a chunk writes its faces before it reads: one pass
    gives the final halo. The reference makes a second pass only to give
    jit static marching-cubes capacities, and retries a chunk whose raster
    overflow passes its cap; eager PyTorch with exact sizes needs neither.
    The mesh is the resident mode's, bit for bit where the splat is
    deterministic (on CUDA the overflow scatter's atomics are not): the
    same raw values, the same smallest-id winner at each shared point,
    triangles in ascending subdomain id and vertices in edge-key order in
    both.

On several devices (``shard_mesh``) the route is sharded: each device holds
the resident store of its x-slab of subdomains, and the mesh is the
one-device mesh (``reconstruct_surface_subdomain_grid``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.density import supported_point_offsets
from splashsurf_tpu_torch.mc.dense import _local_edge_coeffs, edge_layout, lut_tensors
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.neighbors import compute_particle_densities, particle_neighbor_lists
from splashsurf_tpu_torch.ops.global_sweep import check_empty_field
from splashsurf_tpu_torch.ops.global_sweep import pull_quant as _pull_quant
from splashsurf_tpu_torch.ops.splat_kernels import splat_sweep_cuda
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.profiling import StageClock
from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# The reference's streaming switches, read at each call: "0" keeps every
# level set resident at any size, "1" streams, anything else streams past
# the budget of resident level-set bytes, (B + 1) * P^3 * itemsize (the
# reference's own measure and default).
STREAM_ENV = "SPLASHSURF_TPU_STREAM"
STREAM_BUDGET_ENV = "SPLASHSURF_TPU_STREAM_BUDGET_BYTES"
STREAM_BUDGET_BYTES = 3_000_000_000

# Working-set budget of one splat, halo or marching-cubes chunk.
CHUNK_BYTES = 1 << 30

# Raster slots per cell: a pair of rank >= SLOTS in its raster cell goes
# through the scatter splat.
SLOTS = 2

_ABSENT = torch.iinfo(torch.int64).max  # no neighbour subdomain

# Facts about the last run, read by tests and chip_smoke.py, never by the
# pipeline (the reference keeps the same record): occupied subdomains "B",
# resident level-set bytes "ls_bytes", "streamed", the streamed mode's
# "shell_bytes", pair, raster-overflow and chunk counts, the encoded pull's
# "pull_bytes", "stage_s", the seconds of each stage (device seconds only
# with ``enable_profile_sync(True)``; otherwise the host's, up to the
# stage's end of dispatch), and, where STAGE_PEAKS is set on a CUDA run,
# "peak_bytes", each stage's peak of allocated device memory.
LAST_RUN: dict = {}

# When True, the route's stage clock synchronises the device at each stage
# boundary, so that ``LAST_RUN["stage_s"]`` holds device seconds; off by
# default (the reference's ``_PROFILE_SYNC``), when the route waits only
# where it reads counts back and the stage seconds are those of dispatch.
_PROFILE_SYNC = False


def enable_profile_sync(on: bool = True):
    """Synchronise the subdomain route's stage clock at its stage
    boundaries (``on``), or not (the default)."""
    global _PROFILE_SYNC
    _PROFILE_SYNC = on


# Per-stage device memory peaks: the clock resets the allocator's peak
# statistics at every stage boundary, which would hide a caller's own
# reading of the frame's peak, so it is off unless a caller asks.
STAGE_PEAKS = False


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


def decompose(positions, sd: SubdomainGridParams, device=None):
    """Expand particles into (subdomain, particle) pairs with ghost margins
    (the GhostMarginClassifier, dense_subdomains.rs:1751-1906): a particle
    belongs to its own subdomain and to every neighbour whose raster, the
    subdomain's cells plus ``margin_cells`` on each side, contains its cell.

    Returns int64 (n_pairs,) tensors (targets, particle ids, raster cells,
    ranks), sorted by (target, raster cell, particle id): target is the flat
    subdomain id, raster cell the flat index in the (R, R, R) raster, R =
    n_sub + 2 * margin, and rank the position within its raster cell. An
    array goes to ``device`` (``placement.on_device``).
    """
    pid, target, cell = expand_pairs(on_device(positions, device=device), sd)
    return sort_pairs(target, cell, pid, sd)


def expand_pairs(positions: torch.Tensor, sd: SubdomainGridParams,
                 valid: Optional[torch.Tensor] = None):
    """The unsorted pairs of ``decompose``: int64 (particle row, target,
    raster cell) tensors, particle-major, so particle rows ascend. Rows
    where ``valid`` is False make no pair. The sharded decomposition
    (``parallel.decompose``) expands each shard's block of particles with
    this same arithmetic."""
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
    if valid is not None:
        cond &= valid[:, None]

    pid, e = torch.nonzero(cond, as_tuple=True)  # particle-major
    ts = t[pid, e]
    target = sd.subdomain_grid.flatten_cell_index(ts)
    rc = gc[pid] - ts * n_sub + m
    return pid, target, (rc[:, 0] * R + rc[:, 1]) * R + rc[:, 2]


def sort_pairs(target, cell, pid, sd: SubdomainGridParams):
    """Sort pairs by (target, raster cell, particle id) and rank each in its
    raster cell: (targets, particle ids, raster cells, ranks). The particle
    ids must ascend on input (``expand_pairs`` order), so one stable sort on
    the combined (target, raster cell) key gives the three-key order."""
    R = sd.n_sub + 2 * sd.margin_cells
    key, order = torch.sort(target * (R * R * R) + cell, stable=True)
    target, cell, pid = target[order], cell[order], pid[order]

    n_pairs = key.shape[0]
    is_start = torch.ones(n_pairs, dtype=torch.bool, device=key.device)
    is_start[1:] = key[1:] != key[:-1]
    run_first = torch.nonzero(is_start).squeeze(1)
    rank = torch.arange(n_pairs, device=key.device) - run_first[torch.cumsum(is_start, 0) - 1]
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
    compact_support_radius, hsc: int, out: Optional[torch.Tensor] = None, device=None,
):
    """Scatter-add splat: each listed particle (``pids``, with ``rows`` its
    chunk-local subdomain) adds v W(|x_g - x|) to the supported points of
    its subdomain's core [0, n_sub]^3; points outside belong to neighbours
    and are dropped. Returns (or adds into ``out``) the (C, P, P, P) level
    sets, C = len(sub_ijk).

    The lists are exact, so no far dummy particle (and no clip of its
    deltas) is needed. ``index_add_`` runs with atomics on CUDA: the order
    of the sums at a point, and its last bits, change from run to run.
    Arrays go to ``device`` (``placement.on_device``)."""
    positions, values, pids, rows, sub_ijk, out = on_device(
        positions, values, pids, rows, sub_ijk, out, device=device
    )
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
    sd: SubdomainGridParams, compact_support_radius, hsc: int, device=None,
):
    """Raster-sweep splat of a chunk of C = len(sub_ijk) subdomains: (C, P,
    P, P) level sets. Kernel K3 sums the pruned offset fan over the chunk's
    rasters (``chunk_rasters``); the pairs of rank >= SLOTS go through
    ``chunk_levelset_scatter`` into the same level sets. Arrays go to
    ``device`` (``placement.on_device``)."""
    positions, values, pids, rows, cells, ranks, sub_ijk = on_device(
        positions, values, pids, rows, cells, ranks, sub_ijk, device=device
    )
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


def splat_rows(positions, values, pids, cells, ranks, starts, counts, counts_np, sub_ijk,
               rows_np, sd: SubdomainGridParams, compact_support_radius, hsc: int):
    """Level sets (C, P, P, P) of the occupied subdomains ``rows_np`` (host
    row numbers): their pair segments (``starts`` / ``counts`` on the
    device, ``counts_np`` on the host) gathered from the sorted pair
    arrays, and ``chunk_levelset_raster`` over them."""
    dev = pids.device
    rows = torch.as_tensor(rows_np, device=dev)
    idx, row = _gather_pairs(starts, counts, rows, int(counts_np[rows_np].sum()))
    return chunk_levelset_raster(
        positions, values, pids[idx], row, cells[idx], ranks[idx], sub_ijk[rows], sd,
        compact_support_radius, hsc,
    )


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


def _face_index(o) -> Tuple[int, int]:
    """(axis, donor face) of the receiver-to-donor direction ``o``: the
    donor's mirrored region lies in its plane x_a = 0 when o[a] == +1 and
    x_a = P - 1 when -1, a the first axis with o[a] != 0; faces are stored
    [x0, xP, y0, yP, z0, zP]."""
    a = next(ax for ax in range(3) if o[ax] != 0)
    return a, 2 * a + (0 if o[a] == 1 else 1)


def extract_faces(ls: torch.Tensor) -> torch.Tensor:
    """(C, P, P, P) level sets -> (6, C, P * P) boundary faces [x0, xP, y0,
    yP, z0, zP]."""
    C, P = ls.shape[0], ls.shape[1]
    faces = (ls[:, 0], ls[:, P - 1], ls[:, :, 0], ls[:, :, P - 1], ls[:, :, :, 0], ls[:, :, :, P - 1])
    return torch.stack([f.reshape(C, P * P) for f in faces])


@functools.lru_cache(maxsize=8)
def _shell_table(P: int, device: torch.device):
    """The (receiver point, donor) entries of the 26 directions: for entry
    e, direction ``d[e]``, the boundary point ``u[e]`` (an index into
    ``points``, the block's flat boundary point ids, ascending) and the
    donor's face ``face[e]`` and flat index ``fidx[e]`` in it. A point in
    the region of several directions (edges, corners) has one entry per
    direction, each a different holder."""
    d_l, r_l, f_l, i_l = [], [], [], []
    for d, o in enumerate(_DIRS26):
        rng = [np.arange(P)[_region(int(c), P)] for c in o]
        g = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
        a, face = _face_index(o)
        uv = [np.where(o[ax] == 0, g[:, ax], 0 if o[ax] == 1 else P - 1) for ax in range(3) if ax != a]
        d_l.append(np.full(len(g), d))
        r_l.append((g[:, 0] * P + g[:, 1]) * P + g[:, 2])
        f_l.append(np.full(len(g), face))
        i_l.append(uv[0] * P + uv[1])
    recv = np.concatenate(r_l)
    points, u = np.unique(recv, return_inverse=True)
    return tuple(
        torch.as_tensor(x, dtype=torch.int64, device=device)
        for x in (np.concatenate(d_l), u, points, np.concatenate(f_l), np.concatenate(i_l))
    )


def halo_from_shells(ls, own_flat, nb_idx, nb_flat, shells):
    """``halo_overwrite`` for one chunk, in place on ``ls`` (C, P, P, P),
    the candidates gathered from ``shells`` (6, B, P * P), the subdomains'
    raw boundary faces; ``own_flat`` (C,) and ``nb_idx`` / ``nb_flat`` (26,
    C) are the chunk's columns of the neighbour tables.

    ``halo_overwrite`` leaves at every shared point the raw value of its
    smallest-id holder; this pass takes that value from the table for all
    26 directions at once: the smallest donor id per point (a min, so the
    order of the reduction does not matter), and the one entry holding it
    where it is below the receiver's own id. An absent neighbour gathers
    row 0 in range and never wins (its id is ``_ABSENT``)."""
    C, P = ls.shape[0], ls.shape[1]
    d, u, points, face, fidx = _shell_table(P, ls.device)
    cand_flat = nb_flat[d]  # (M, C)
    best = own_flat[None].expand(points.shape[0], C).clone()
    best.scatter_reduce_(0, u[:, None].expand(-1, C), cand_flat, "amin")
    take = (cand_flat == best[u]) & (cand_flat < own_flat[None])
    e, c = torch.nonzero(take, as_tuple=True)
    flat = ls.view(C, P * P * P)
    flat[c, points[u[e]]] = shells[face[e], nb_idx[d[e], c], fidx[e]]
    return ls


# ---------------------------------------------------------------------------
# batched marching cubes and stitching
# ---------------------------------------------------------------------------


def _chunk_edges_and_cases(ls: torch.Tensor, iso: float):
    """The active-edge masks of a (C, P, P, P) chunk, one per axis (the x,
    y and z edge arrays of each block, (C, P-1, P, P) etc.), and its (C,
    P-1, P-1, P-1) int64 case indices; ``iso`` is rounded to the field's
    dtype by the caller."""
    inside = ls >= iso
    masks = []
    for a in range(3):
        lo = (slice(None),) + tuple(slice(0, -1) if d == a else slice(None) for d in range(3))
        hi = (slice(None),) + tuple(slice(1, None) if d == a else slice(None) for d in range(3))
        masks.append(inside[lo] != inside[hi])
    n = ls.shape[1] - 1
    case = torch.zeros((ls.shape[0], n, n, n), dtype=torch.int64, device=ls.device)
    for c8 in range(8):
        oi, oj, ok = (c8 >> 2) & 1, (c8 >> 1) & 1, c8 & 1
        case |= inside[:, oi : oi + n, oj : oj + n, ok : ok + n].long() << c8
    return masks, case


def chunk_mc_counts(ls: torch.Tensor, sd: SubdomainGridParams, iso):
    """Per-block (vertex, triangle, boundary-vertex) counts of a (C, P, P,
    P) chunk, three (C,) int64 tensors on its device. A vertex is on the
    boundary when its edge lies in a plane shared with a neighbour (a
    coordinate other than its axis at 0 or P-1): only those can come out of
    two blocks, so only those need the stitch's merge."""
    P = ls.shape[1]
    masks, case = _chunk_edges_and_cases(ls, kernels.rounded(iso, ls.dtype))
    nv = sum(m.flatten(1).sum(1) for m in masks)
    nb = 0
    for a, m in enumerate(masks):
        onplane = torch.zeros(m.shape[1:], dtype=torch.bool, device=ls.device)
        for d in range(3):
            if d != a:
                idx = [slice(None)] * 3
                idx[d] = [0, P - 1]
                onplane[tuple(idx)] = True
        nb = nb + (m & onplane).flatten(1).sum(1)
    count_t, _ = lut_tensors(ls.device)
    nt = count_t[case].flatten(1).sum(1)
    return nv, nt, nb


def chunk_mc(ls, sub_ijk, sd: SubdomainGridParams, iso, device=None):
    """Marching cubes over the (C, P, P, P) level sets of a chunk, the batch
    folded into the flat edge and cell index spaces.

    Returns (vertices (V, 3), keys (V,), triangles (T, 3)): one vertex per
    active edge in (subdomain, x/y/z edge array, base point) order, keyed by
    its global edge ((i * npy + j) * npz + k) * 3 + axis, and triangles in
    (subdomain, cell, case-table slot) order with chunk-local vertex
    indices. Edges on a face shared with a neighbour come out of both; the
    stitch merges them. Arrays go to ``device`` (``placement.on_device``).
    """
    ls, sub_ijk = on_device(ls, sub_ijk, device=device)
    dtype, dev = ls.dtype, ls.device
    C, P = ls.shape[0], ls.shape[1]
    g = sd.global_grid
    _, npy, npz = g.n_points
    iso = kernels.rounded(iso, dtype)
    cs = kernels.rounded(g.cell_size, dtype)
    masks, case = _chunk_edges_and_cases(ls, iso)
    mask = torch.cat([m.reshape(C, -1) for m in masks], dim=1).reshape(-1)
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
# the encoded mesh pull: owned-point streams and the host decode
# ---------------------------------------------------------------------------
#
# (the reference's subdomains.py:1416-1885, the default there.) Every
# global grid point has one owner subdomain: the point of local coordinates
# (i, j, k) is owned iff i, j, k < n_sub (the far planes are the +1
# neighbour's local 0). A point's cell case and its +x/+y/+z edges are then
# computable in its block, and every cell and edge of the grid is emitted
# by exactly one subdomain: no duplicate vertex, no stitch. A cell's
# far-face edges belong to neighbour subdomains' points, which the host
# decoder finds by their global point id; the halo makes the shared planes'
# values, and so the edges' activity and t, equal across blocks.
#
# Each subdomain's stream is a run of u32 words (local id << 11 | case |
# edge bits) and a run of its owned edges' t, point-major; the runs come
# to the host in the reference's canonical order, the active rows sorted
# by max(owned edges, triangles) (``encoded_run_order``), whatever order the
# chunks, the streamed mode or the shards computed them in.


def use_encoded_pull(sd: SubdomainGridParams) -> bool:
    """The encoded pull on the subdomain route: ``SPLASHSURF_TPU_SUB_
    ENCODED_PULL`` "1" (read at each call; the port's default is "0", the
    stitch; the reference's is "1") and (P - 1)^3 <= 2^21, so that a local
    point id fits the word's 21 bits (the reference's gate,
    subdomains.py:2408-2415)."""
    return (os.environ.get("SPLASHSURF_TPU_SUB_ENCODED_PULL", "0") == "1"
            and (sd.points_per_dim - 1) ** 3 <= (1 << 21))


def _owned_words(ls: torch.Tensor, iso: float) -> torch.Tensor:
    """The (C, n, n, n) int64 words of a chunk's owned points (n = P - 1):
    the cell case where the cell is neither all inside nor all outside, in
    bits 0-7, and the three origin edges' activity in bits 8-10."""
    n = ls.shape[1] - 1
    inside = ls >= iso
    case = torch.zeros((ls.shape[0], n, n, n), dtype=torch.int64, device=ls.device)
    for c8 in range(8):
        oi, oj, ok = (c8 >> 2) & 1, (c8 >> 1) & 1, c8 & 1
        case |= inside[:, oi : oi + n, oj : oj + n, ok : ok + n].long() << c8
    word = torch.where((case != 0) & (case != 255), case, 0)
    base = inside[:, :n, :n, :n]
    for a in range(3):
        nb = inside[:, int(a == 0) : int(a == 0) + n, int(a == 1) : int(a == 1) + n,
                    int(a == 2) : int(a == 2) + n]
        word |= (base != nb).long() << (8 + a)
    return word


def chunk_mc_counts_encoded(ls: torch.Tensor, sd: SubdomainGridParams, iso):
    """Per-block (active owned points, owned active edges, triangles) of a
    (C, P, P, P) chunk, three (C,) int64 tensors on its device: the exact
    sizes of its encoded streams and their totals (the reference's
    ``chunk_mc_counts_encoded``)."""
    word = _owned_words(ls, kernels.rounded(iso, ls.dtype)).flatten(1)
    count_t, _ = lut_tensors(ls.device)
    edges = sum((word >> (8 + a)) & 1 for a in range(3))
    return (word != 0).sum(1), edges.sum(1), count_t[word & 0xFF].sum(1)


def chunk_mc_encode(ls, sd: SubdomainGridParams, iso,
                    pack_point_capacity: Optional[int] = None,
                    pack_vertex_capacity: Optional[int] = None, quant_t: bool = False,
                    device=None):
    """Encoded marching cubes over a (C, P, P, P) chunk: its active owned
    points in (block, local id) order, each a u32 word ``local_id << 11 |
    case (8 bits) | edge bits (3 bits)``, and one edge parameter t per owned
    active edge in (point, axis) order (the reference's
    ``chunk_mc_encode``, subdomains.py:1481-1583). Global ids stay off the
    device: the host rebuilds them from the per-block counts and the
    blocks' coordinates.

    Returns (packed u32, t, counts (C,) int64, total_v): with the
    capacities, lists of those sizes (zero past the active points and
    edges) and nothing read back; without them, of their exact sizes. t is
    u16 (round(t * 65535)) with ``quant_t``. An array goes to ``device``
    (``placement.on_device``)."""
    ls = on_device(ls, device=device)
    dtype, dev = ls.dtype, ls.device
    C, P = ls.shape[0], ls.shape[1]
    ns = P - 1
    n3 = ns * ns * ns
    if n3 > (1 << 21):
        raise ValueError("the encoded pull supports n_sub <= 128")
    iso = kernels.rounded(iso, dtype)
    wflat = _owned_words(ls, iso).reshape(-1)
    active = wflat != 0
    src = kernels.compact_indices(active, pack_point_capacity)
    valid = src < C * n3
    src = src.clamp_max(C * n3 - 1)
    w = torch.where(valid, wflat[src], 0)
    local = src % n3
    packed = torch.where(valid, (local << 11) | w, 0).to(torch.uint32)
    counts = active.reshape(C, n3).sum(1)

    e = [(w >> (8 + a)) & 1 for a in range(3)]
    nedges = e[0] + e[1] + e[2]
    vbase = torch.cumsum(nedges, 0) - nedges
    total_v = nedges.sum()
    vcap = int(total_v) if pack_vertex_capacity is None else pack_vertex_capacity
    row = src // n3
    li, lj, lk = local // (ns * ns), (local // ns) % ns, local % ns
    p0 = row * (P * P * P) + (li * P + lj) * P + lk
    ls_flat = ls.reshape(-1)
    v0 = ls_flat[p0]
    tvals = torch.zeros(vcap + 1, dtype=dtype, device=dev)  # vcap: a drop slot
    offs = (torch.zeros_like(e[0]), e[0], e[0] + e[1])
    for a in range(3):
        denom = ls_flat[(p0 + (P * P, P, 1)[a]).clamp_max(ls_flat.numel() - 1)] - v0
        t_a = torch.clamp(
            (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
        )
        dest = torch.where(e[a] == 1, (vbase + offs[a]).clamp_max(vcap), vcap)
        tvals.index_put_((dest,), t_a)
    tvals = tvals[:vcap]
    if quant_t:
        tvals = torch.round(tvals * 65535.0).to(torch.uint16)
    return packed, tvals, counts, total_v


def encoded_run_order(ap: np.ndarray, oe: np.ndarray, tc: np.ndarray) -> np.ndarray:
    """The reference's run order of the encoded streams: the rows with an
    active point, stably sorted by max(owned edges, triangles)."""
    active = np.nonzero(ap > 0)[0]
    return active[np.argsort(np.maximum(oe, tc)[active], kind="stable")]


def _grouped_arange(starts: torch.Tensor, lens: torch.Tensor, total: int) -> torch.Tensor:
    """The concatenation of arange(s, s + l) over (starts, lens), on their
    device, ``total`` = sum(lens) entries."""
    excl = torch.cumsum(lens, 0) - lens
    return (torch.repeat_interleave(starts - excl, lens, output_size=total)
            + torch.arange(total, device=lens.device))


def _compact_streams(packs, order_rows, rows_stream, ap, oe):
    """One stream pair in the canonical run order from the packs computed
    in another: ``packs`` is a list of (packed, t, rows) per chunk, its
    rows' runs in the order of ``rows`` (int64 host array); the packs are
    concatenated on the first one's device, and, where the chunks' order is
    not ``order_rows``, their runs regathered there into it (the
    reference's ``_compact_streams`` drops its packs' padding instead; the
    port's packs have none). Returns (packed, t) device tensors."""
    dev = packs[0][0].device
    packed = torch.cat([p[0].to(dev) for p in packs])
    t = torch.cat([p[1].to(dev) for p in packs])
    if len(rows_stream) == len(order_rows) and np.array_equal(rows_stream, order_rows):
        return packed, t
    pos = np.full(len(ap), -1, np.int64)
    pos[rows_stream] = np.arange(len(rows_stream))
    out = []
    for x, lens in ((packed, ap), (t, oe)):
        ls_stream = lens[rows_stream]
        starts = (np.cumsum(ls_stream) - ls_stream)[pos[order_rows]]
        total = int(lens[order_rows].sum())
        idx = _grouped_arange(torch.as_tensor(starts, device=dev),
                              torch.as_tensor(lens[order_rows], device=dev), total)
        # CUDA gathers no unsigned words: gather their signed view
        signed = {torch.uint32: torch.int32, torch.uint16: torch.int16}.get(x.dtype)
        out.append(x[idx] if signed is None else x.view(signed)[idx].view(x.dtype))
    return tuple(out)


def _decode_sub_mesh_np(packed, tstr, run_counts, run_base, ns: int, grid: UniformGrid,
                        quant_t: bool):
    """The numpy decoder of the owned-point streams (the reference's
    ``_decode_sub_mesh_np``, subdomains.py:1633-1731): the mesh of the
    native ``mc_decode_sub``, up to the multiply-add of the vertex
    positions, in the streams' dtype (the decoder of f64 streams and of
    hosts without a compiler). Returns (vertices, triangles int32)."""
    from splashsurf_tpu_torch.mc import lut

    packed = np.asarray(packed, np.uint32)
    total_c = packed.shape[0]
    tstr = np.asarray(tstr)
    if quant_t:
        tstr = tstr.astype(np.float32) * np.float32(1.0 / 65535.0)
    dtype = tstr.dtype
    npy, npz = int(grid.n_points[1]), int(grid.n_points[2])

    base = np.repeat(np.asarray(run_base, np.int64), np.asarray(run_counts), axis=0)
    local = (packed >> 11).astype(np.int64)
    word = (packed & 0x7FF).astype(np.int64)
    g = base + np.stack([local // (ns * ns), (local // ns) % ns, local % ns], axis=1)
    gflat = (g[:, 0] * npy + g[:, 1]) * npz + g[:, 2]

    ebits = np.stack([(word >> (8 + a)) & 1 for a in range(3)], axis=1)
    nedges = ebits.sum(1)
    vbase = np.cumsum(nedges) - nedges
    total_v = int(nedges.sum())
    if total_v != tstr.shape[0]:
        raise RuntimeError("encoded transfer decode inconsistency (vertices)")

    # vertices: point-major, axes in order
    mn = np.asarray(grid.min, dtype)
    cs = np.asarray(grid.cell_size, dtype)
    vaxis = np.empty(total_v, np.int8)
    vslot = np.empty(total_v, np.int64)
    for a in range(3):
        sel = ebits[:, a] == 1
        vo = vbase[sel] + ebits[sel, :a].sum(1)
        vaxis[vo] = a
        vslot[vo] = np.nonzero(sel)[0]
    verts = mn[None, :] + g[vslot].astype(dtype) * cs
    verts[np.arange(total_v), vaxis] += tstr * cs

    # neighbour slots: sorted global ids, one search per offset
    order = np.argsort(gflat, kind="stable")
    sg = gflat[order]
    nbr = np.empty((8, total_c), np.int64)
    nbr[0] = np.arange(total_c)
    pzy = npy * npz
    for off in range(1, 8):
        di, dj, dk = (off >> 2) & 1, (off >> 1) & 1, off & 1
        tgt = gflat + (di * pzy + dj * npz + dk)
        pos_s = np.searchsorted(sg, tgt)
        pos_c = np.minimum(pos_s, total_c - 1)
        hit = (pos_s < total_c) & (sg[pos_c] == tgt)
        nbr[off] = np.where(hit, order[pos_c], -1)

    # triangles in stream order
    case = word & 0xFF
    counts = np.asarray(lut.TRI_COUNT, np.int64)[case]
    total_t = int(counts.sum())
    owner = np.repeat(np.arange(total_c), counts)
    slot_in = np.arange(total_t) - (np.cumsum(counts) - counts)[owner]
    tri_tab = np.where(lut.TRI_TABLE >= 0, lut.TRI_TABLE, 0)
    ea = np.asarray(lut.EDGE_AXIS, np.int64)
    eb = np.asarray(lut.EDGE_BASE_OFFSET, np.int64)
    eoff = eb[:, 0] * 4 + eb[:, 1] * 2 + eb[:, 2]
    tris = np.empty((total_t, 3), np.int32)
    acase = case[owner]
    for corner in range(3):
        le = tri_tab[acase, slot_in, corner]
        a = ea[le]
        nslot = nbr[eoff[le], owner]
        if np.any(nslot < 0):
            raise RuntimeError("encoded transfer decode inconsistency (owner)")
        if np.any(ebits[nslot, a] == 0):
            raise RuntimeError("encoded transfer decode inconsistency (edge)")
        below = np.zeros(total_t, np.int64)
        for b in range(2):
            below += np.where(a > b, ebits[nslot, b], 0)
        tris[:, corner] = (vbase[nslot] + below).astype(np.int32)
    return verts, tris


def _decode_encoded_streams(packed_h, t_h, run_counts, run_base, ns: int, grid: UniformGrid,
                            dtype: torch.dtype, quant: bool, total_v: int, total_t: int):
    """The host mesh of the owned-point streams: the native decoder
    (``native.mc_decode_sub``) in f32, the numpy one in f64 or where the
    native library cannot be built, both counted in
    ``native.DECODE_STATS``."""
    from splashsurf_tpu_torch import native

    res = None
    if dtype == torch.float32:
        res = native.mc_decode_sub(
            t_h, packed_h, run_counts, run_base, total_v, total_t, ns,
            int(grid.n_points[1]), int(grid.n_points[2]), grid.min, grid.cell_size, quant,
        )
    if res is None:
        native.DECODE_STATS["numpy"] += 1
        res = _decode_sub_mesh_np(packed_h, t_h, run_counts, run_base, ns, grid, quant)
    return res


def encode_record() -> dict:
    """An empty record of encoded chunks: their global rows, per-row counts
    ((3, C) device tensors), packs and level-set maxima."""
    return dict(rows=[], counts=[], packs=[], ls_max=[])


def _encode_chunk(ls, rows: np.ndarray, sd: SubdomainGridParams, iso, quant: bool, enc: dict):
    """Append a chunk's per-row encoded counts and its packs (exact sizes)
    to ``enc`` (``encode_record()``): ``ls`` holds the level sets of the
    global rows ``rows``, after the halo."""
    counts = chunk_mc_counts_encoded(ls, sd, iso)
    packed, t, _, _ = chunk_mc_encode(ls, sd, iso, quant_t=quant)
    enc["rows"].append(np.asarray(rows, np.int64))
    enc["counts"].append(torch.stack(counts))
    enc["packs"].append((packed, t))
    enc["ls_max"].append(ls.max())


def _mc_encoded_mesh(encs, occ_ids, sd: SubdomainGridParams, iso, dtype, clock: StageClock):
    """The host mesh of the encoded packs (the reference's
    ``_mc_encoded_mesh``, subdomains.py:1762-1862): ``encs`` are the
    ``_encode_chunk`` records (one per device, in device order, or one),
    their rows together every occupied row once. The per-row counts come
    back to the host, the runs are regathered into ``encoded_run_order``
    and pulled in one copy, then decoded (``mc_decode_sub``). Laps "pull"
    and "decode"; ``LAST_RUN`` gets "pull_bytes"."""
    from splashsurf_tpu_torch.ops.global_sweep import PendingPull

    dev0 = next(p[0].device for e in encs for p in e["packs"])
    rows = np.concatenate([r for e in encs for r in e["rows"]])
    counts = torch.cat([c.to(dev0) for e in encs for c in e["counts"]], dim=1).cpu().numpy()
    B = len(occ_ids)
    ap, oe, tc = (np.zeros(B, np.int64) for _ in range(3))
    ap[rows], oe[rows], tc[rows] = counts
    order = encoded_run_order(ap, oe, tc)
    ns_ = sd.points_per_dim - 1
    quant = _pull_quant(dtype)
    total_v, total_t = int(oe.sum()), int(tc.sum())
    if len(order) == 0:
        check_empty_field(0, max(float(m) for e in encs for m in e["ls_max"]), float(iso))
        return None
    packs = [p for e in encs for p in e["packs"]]
    packed, t = _compact_streams(packs, order, rows, ap, oe)
    del packs
    host = PendingPull(None, [packed, t]).host_parts()
    LAST_RUN["pull_bytes"] = sum(h.numel() * h.element_size() for h in host)
    clock.lap("pull")
    nsub = sd.num_subdomains
    oid = occ_ids[order]
    sub_ijk = np.stack([oid // (nsub[1] * nsub[2]), (oid // nsub[2]) % nsub[1], oid % nsub[2]], 1)
    verts, tris = _decode_encoded_streams(
        host[0].numpy(), host[1].numpy(), ap[order], sub_ijk * ns_, ns_, sd.global_grid,
        dtype, quant, total_v, total_t,
    )
    clock.lap("decode")
    return TriMesh3d(vertices=verts, triangles=tris)


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


# Working set of marching cubes per level-set point (``chunk_mc``'s masks,
# case indices and cumulative sums).
MC_POINT_BYTES = 48


def _splat_bytes(sd: SubdomainGridParams, itemsize: int) -> int:
    """A subdomain's splat working set: its 4 rasters and its level set."""
    Rp = sd.n_sub + 2 * sd.margin_cells + 2
    return (4 * SLOTS * Rp**3 + sd.points_per_dim**3) * itemsize


def splat_plan(counts: np.ndarray, sd: SubdomainGridParams, itemsize: int, chunk_bytes: int):
    """The splat's chunks: occupied-subdomain rows in ascending occupancy,
    cut so that each chunk's rasters, level sets and pair arrays stay
    within ``chunk_bytes``."""
    per_row = _splat_bytes(sd, itemsize) + 64 * counts
    return _chunks(np.argsort(counts, kind="stable"), per_row, chunk_bytes)


def use_stream(ls_bytes: int) -> bool:
    """The reference's streaming gate, its switches read at each call:
    ``SPLASHSURF_TPU_STREAM`` "0" never streams, "1" always, anything else
    (default "auto") past ``SPLASHSURF_TPU_STREAM_BUDGET_BYTES`` of resident
    level sets."""
    env = os.environ.get(STREAM_ENV, "auto")
    budget = int(os.environ.get(STREAM_BUDGET_ENV, STREAM_BUDGET_BYTES))
    return env != "0" and (env == "1" or ls_bytes > budget)


def stream_plan(counts: np.ndarray, sd: SubdomainGridParams, itemsize: int, chunk_bytes: int):
    """The streamed mode's chunks: rows in ascending subdomain id (the halo
    reads its donors' faces from the table, so they must come first), cut so
    that each chunk's splat (as in ``splat_plan``) and marching-cubes working
    set stay within ``chunk_bytes``."""
    mc = MC_POINT_BYTES * sd.points_per_dim**3
    per_row = _splat_bytes(sd, itemsize) + mc + 64 * counts
    return _chunks(np.arange(len(counts)), per_row, chunk_bytes)


# The reference's sharding switches, read at each call: with more than one
# device, ``sharded=None`` shards from SHARD_MIN_N particles on; "0" for
# SHARD_DECOMP_ENV decomposes on one device and splits the pairs into the
# shards' slabs (the same mesh).
SHARD_MIN_N_ENV = "SPLASHSURF_TPU_SHARD_MIN_N"
SHARD_MIN_N = 262144
SHARD_DECOMP_ENV = "SPLASHSURF_TPU_SHARD_DECOMP"


def shard_mesh(sharded: Optional[bool], n: int, device: torch.device):
    """The mesh the route shards over, or None for one device: the
    process's devices of the positions' type (``parallel.mesh.devices``)
    when they are more than one and ``sharded`` is True, or None and ``n``
    reaches ``SPLASHSURF_TPU_SHARD_MIN_N`` (default 262144)."""
    from splashsurf_tpu_torch.parallel.mesh import make_mesh

    if sharded is False:
        return None
    mesh = make_mesh(device=device)
    if mesh.size <= 1:
        return None
    if sharded is None and n < int(os.environ.get(SHARD_MIN_N_ENV, SHARD_MIN_N)):
        return None
    return mesh


def reconstruct_surface_subdomain_grid(
    positions,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    chunk_bytes: int = CHUNK_BYTES,
    sharded: Optional[bool] = None,
    n_valid: Optional[int] = None,
    device=None,
):
    """Subdomain-grid reconstruction on the positions' device (reference
    subdomains.py:1885). The mesh comes back to the host; the per-particle
    densities stay a device tensor. ``chunk_bytes`` bounds each chunk's
    working set; the result does not depend on it. Rows past ``n_valid``
    are count-padding dummies: they make no pair and get density 0. An
    array goes to ``device`` (``placement.on_device``).

    On one device the route is resident or streamed, as ``use_stream``
    decides. Where ``shard_mesh`` gives a mesh of several devices (real
    cards, or virtual shards of one), it runs sharded and never streams:
    the sharded densities (``parallel.density``), the sharded decomposition
    (``parallel.decompose``; with ``SPLASHSURF_TPU_SHARD_DECOMP=0`` the
    single-device one, its rows split into the same slabs), then per shard,
    on its device, the splat of its x-slab of subdomains with kernel K3 into
    a resident store, the halo across shards and marching cubes in ascending
    id (``parallel.mesh.sharded_levelset_step``), and one stitch on the
    mesh's first device. The shards' patches, concatenated in device order,
    are in the single-device order, so the mesh is the single-device mesh."""
    from splashsurf_tpu_torch.parallel.decompose import decompose_sharded, split_decomposition
    from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded
    from splashsurf_tpu_torch.parallel.mesh import DeviceMesh, _levelset_mc_step

    positions = on_device(positions, device=device)
    dev = positions.device
    dtype = positions.dtype
    itemsize = torch.finfo(dtype).bits // 8
    n = positions.shape[0]
    nv = n if n_valid is None else min(int(n_valid), n)
    sd = initialize_parameters(parameters, grid)
    h = parameters.compact_support_radius
    hsc = sd.margin_cells
    iso = parameters.iso_surface_threshold
    P = sd.points_per_dim
    mesh = shard_mesh(sharded, n, dev)
    LAST_RUN.clear()
    clock = StageClock(dev, track_peaks=STAGE_PEAKS, sync=_PROFILE_SYNC)
    encoded = use_encoded_pull(sd)

    if mesh is None:
        rho = compute_particle_densities(positions[:nv], h, parameters.particle_rest_mass)
        rho = torch.cat([rho, rho.new_zeros(n - nv)]) if nv < n else rho
    else:
        rho = compute_particle_densities_sharded(
            positions, h, parameters.particle_rest_mass, mesh=mesh, n_valid=nv
        )
    values = kernels.rounded(parameters.particle_rest_mass, dtype) / rho
    clock.lap("densities")

    sharded_pairs = mesh is not None and os.environ.get(SHARD_DECOMP_ENV, "1") == "1"
    if sharded_pairs:
        shards = decompose_sharded(positions, sd, mesh, n_valid=nv)["shards"]
    else:
        targets, pids, cells, ranks = decompose(positions[:nv], sd)
        occ_ids, starts, counts = occupied_segments(targets)
        shards = [dict(pids=pids, cells=cells, ranks=ranks, occ_ids=occ_ids, starts=starts,
                       counts=counts)]
        del targets, pids, cells, ranks
        if mesh is not None:
            shards = split_decomposition(shards[0], sd, mesh)
    occ_ids = np.concatenate([s["occ_ids"] for s in shards])
    B = len(occ_ids)
    ls_bytes = (B + 1) * P**3 * itemsize
    streamed = mesh is None and use_stream(ls_bytes)
    LAST_RUN.update(
        B=B, ls_bytes=ls_bytes, streamed=streamed,
        n_pairs=sum(int(s["pids"].shape[0]) for s in shards),
        raster_overflow=sum(int((s["ranks"] >= SLOTS).sum()) for s in shards),
        n_subdomains=sd.num_subdomains, stage_s=clock.times,
        sharded=mesh is not None, sharded_pairs=sharded_pairs,
        devices=[str(d) for d in (mesh.devices if mesh is not None else (dev,))],
    )
    if clock.peaks is not None:
        LAST_RUN["peak_bytes"] = clock.peaks
    clock.lap("decomposition")

    def result(mesh):
        return SurfaceReconstruction(
            grid=sd.global_grid, subdomain_grid=sd.subdomain_grid, mesh=mesh,
            particle_densities=rho,
            particle_neighbors=particle_neighbor_lists(positions, parameters),
            particle_inside_aabb=particle_inside_aabb,
        )

    def empty():
        return TriMesh3d(np.zeros((0, 3), kernels.np_dtype(dtype)), np.zeros((0, 3), np.int32))

    if B == 0:
        return result(empty())

    if not streamed:
        # resident, on one device or sharded: each device's store of level
        # sets, the halo across them, marching cubes in ascending id
        dmesh = mesh if mesh is not None else DeviceMesh((dev,))
        quant = _pull_quant(dtype) if encoded else None
        out = _levelset_mc_step(dmesh, positions, values, shards, sd, h, iso, chunk_bytes, clock,
                                encode=quant)
        del shards
        if mesh is not None:
            LAST_RUN["shards"] = [
                dict(device=str(d), B=o["B"], n_pairs=o["n_pairs"],
                     splat_chunks=o["splat_chunks"], stage_s=o["stage_s"])
                for d, o in zip(mesh.devices, out)
            ]
            LAST_RUN["shell_bytes"] = 6 * B * P * P * itemsize
        LAST_RUN["splat_chunks"] = sum(o["splat_chunks"] for o in out)
        if encoded:
            encs = [o["enc"] for o in out]
            del out
            return result(_mc_encoded_mesh(encs, occ_ids, sd, iso, dtype, clock) or empty())
        # stitched on the mesh's first device, the patches in device order
        dev = dmesh.devices[0]
        verts, keys, tris = ([x.to(dev) for o in out for x in o[k]]
                             for k in ("vertices", "keys", "triangles"))
        ls_max = max(o.get("ls_max", -np.inf) for o in out)
        del out
        return result(_stitched(verts, keys, tris, ls_max, iso, empty, clock))

    # streamed, one device: chunks in ascending subdomain id, each splatted,
    # its raw faces written into the shell table, its halo taken from the
    # table, its marching cubes run
    (s,) = shards
    del shards
    counts = s["counts"]
    ns = sd.num_subdomains
    sub_ijk_np = np.stack(
        [occ_ids // (ns[1] * ns[2]), (occ_ids // ns[2]) % ns[1], occ_ids % ns[2]], axis=1
    )
    sub_ijk = torch.as_tensor(sub_ijk_np, device=dev)
    starts_d = torch.as_tensor(s["starts"], device=dev)
    counts_d = torch.as_tensor(counts, device=dev)
    nb_idx, nb_flat = _neighbor_tables(occ_ids, sub_ijk_np, sd)
    own_flat = torch.as_tensor(occ_ids, device=dev)
    nb_idx = torch.as_tensor(nb_idx, device=dev)
    nb_flat = torch.as_tensor(nb_flat, device=dev)
    shells = torch.empty((6, B, P * P), dtype=dtype, device=dev)
    LAST_RUN["shell_bytes"] = shells.numel() * itemsize
    plan = stream_plan(counts, sd, itemsize, chunk_bytes)
    ls_max = torch.full((), -torch.inf, dtype=dtype, device=dev)
    verts, keys, tris = [], [], []
    enc = encode_record()
    for rows_np in plan:
        b0, b1 = int(rows_np[0]), int(rows_np[-1]) + 1
        ls = splat_rows(positions, values, s["pids"], s["cells"], s["ranks"], starts_d, counts_d,
                        counts, sub_ijk, rows_np, sd, h, hsc)
        clock.lap("splat")
        shells[:, b0:b1] = extract_faces(ls)
        halo_from_shells(ls, own_flat[b0:b1], nb_idx[:, b0:b1], nb_flat[:, b0:b1], shells)
        ls_max = torch.maximum(ls_max, ls.max())
        clock.lap("halo")
        if encoded:
            _encode_chunk(ls, rows_np, sd, iso, _pull_quant(dtype), enc)
        else:
            v, k, t = chunk_mc(ls, sub_ijk[b0:b1], sd, iso)
            verts.append(v)
            keys.append(k)
            tris.append(t)
        del ls
        clock.lap("marching cubes")
    del shells, s
    LAST_RUN["splat_chunks"] = len(plan)
    if encoded:
        return result(_mc_encoded_mesh([enc], occ_ids, sd, iso, dtype, clock) or empty())
    return result(_stitched(verts, keys, tris, ls_max, iso, empty, clock))


def _stitched(verts, keys, tris, ls_max, iso, empty, clock: StageClock):
    """The stitched host mesh of the marching-cubes patches, or the empty
    mesh (after the reference's empty-field check) when they hold no
    triangle; laps "stitch"."""
    if all(t.shape[0] == 0 for t in tris):
        check_empty_field(0, float(ls_max), float(iso))
        mesh = empty()
    else:
        v, t = stitch(verts, keys, tris)
        mesh = TriMesh3d(vertices=v.cpu().numpy(), triangles=t.cpu().numpy())
    clock.lap("stitch")
    return mesh
