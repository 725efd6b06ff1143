"""Dense global reconstruction: raster splat + cell-list marching cubes on
the full background grid (PyTorch port of the dense path of
``splashsurf_tpu.ops.global_sweep``).

Pipeline:
  1. ``rasterize_global`` - particles -> per-cell slot rasters of cell
     fractions and weights, plus the overflow list (cells with more
     particles than slots): kernel K6 (``splat_kernels.slot_raster_cuda``)
     on the card, its plain version on the CPU, the same bits; on the
     cell-raster densities, the fraction rasters and per-particle slot
     meta, from which ``density_weights_from_rasters`` (kernel K4) makes the
     weights and the densities;
  2. ``sweep_global`` - the level set on every grid point: the stencil sweep
     over the rasters (kernel K1) plus a scatter splat of the overflow;
  3. ``mc_global_cells`` - marching cubes: the active points with their
     words and edge parameters (``mc_point_words``), then vertices and
     triangles on the device (``mc_mesh_from_points``).

The slab route (``ops.slab_sweep``) runs steps 1-2 and the first half of 3
per x-slab of the grid (the functions' slab arguments) and the second half
once over the merged active points; there every intermediate has its exact
size, and counts are read back where they are needed.

The dense route (``reconstruct_global_dense``) runs on the reference's
speculative plans (``ops/global_sweep.py:937-970, 1196-1565`` of the
reference, kept by ``plans``): the raster overflow list has a planned
capacity (``plans.OVER_PLAN``), marching cubes writes into buffers of
planned vertex and triangle capacities (``plans.MC_CAPS``), and the mesh
comes to the host in planned buckets (``plans.PULL_PLAN``), together with
the totals and the caller's deferred checks, in one copy (``PendingPull``).
A frame whose plans are all in place reads nothing back before that copy;
a check that fails there is a miss, which updates the plans as the
reference does and re-runs the frame.

The copy is the mesh itself (the packed pull, the port's default) or, with
``SPLASHSURF_TPU_PULL=encoded`` (the reference's default), the encoded
streams of ``mc_global_cells(encode=True)``: per active point a u16 word
with its offset in its 32-point block, u8 active counts per block, and one
edge parameter per vertex, u16 where ``SPLASHSURF_TPU_PULL_QUANT`` asks
(the default, f32 only); the host rebuilds the mesh with the native decoder
(``native.mc_decode``) or, in f64, the numpy one (``pull_mode``).
``SPLASHSURF_TPU_MC=edges`` takes the edge-major ``mc_global_packed`` and
the packed pull. No kernel is involved in either: both are plain PyTorch,
as in the reference they are XLA code.
"""

from __future__ import annotations

import functools
import itertools
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels, plans
from splashsurf_tpu_torch.density import supported_point_offsets
from splashsurf_tpu_torch.mc import lut
from splashsurf_tpu_torch.mc.dense import _case_indices, _local_edge_coeffs, edge_layout, lut_tensors
from splashsurf_tpu_torch.ops.splat_kernels import (
    cell_of, pair_sweep_cuda, slot_raster_cuda, sweep_global_cuda,
)
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.profiling import profile, read_back, redo_span, to_host
from splashsurf_tpu_torch.uniform_grid import UniformGrid


def rasterize_global(positions, values, grid: UniformGrid, slots: int, hsc: int,
                     overflow_capacity: Optional[int] = None, with_meta: bool = False,
                     slab_ncx: Optional[int] = None, slab_x0: Optional[int] = None,
                     device=None):
    """Rasterize particles into per-cell slot tables over the whole grid.

    Returns ``(fx, fy, fz, fv), (opx, opy, opz, oval)``: four (slots, Xp, Yp,
    Zp) rasters with Xp = ncx + 2*(hsc+1) etc. (cells padded by the sweep's
    reach on every side), fracs relative to the cell corner (far sentinel in
    empty slots) and weights (0 in empty slots); then the particles whose
    cell already held ``slots`` occupants, in ascending particle index.

    With ``with_meta`` (the cell-raster densities; ``values`` is not read)
    returns ``(fx, fy, fz), n_overflow, (rank, ok, cx, cy, cz)`` instead: the
    three fraction rasters and no value raster, the exact overflow count
    (one read-back), and per particle its slot rank, whether it holds a slot
    and its cell, int64 (``rasterize_global(..., with_meta=True)`` of the
    reference).

    With ``overflow_capacity`` (the dense route's overflow plan) nothing is
    read back: the overflow list has that fixed size (ascending index, the
    rest padded with far positions -1e30 and weight 0, past the capacity
    cut), and its true count comes as a device scalar: ``(rasters,
    overflow, n_overflow)``, or with ``with_meta`` ``(fracs, n_overflow,
    meta)``. The caller checks the count against the capacity.

    The table covers the global cells [x0 - pad, x0 + W + pad) in x, halo
    bands included, so Xp = W + 2*pad: W = ``slab_ncx`` from x0 =
    ``slab_x0`` (one slab of the slab route, ``ops.slab_sweep``), by default
    the whole grid (W = ncx, x0 = 0). Cells and fracs are computed against
    the global grid origin, so a particle's fraction has the same bits
    whichever slab rasterizes it.

    Slot ranks follow ascending particle index within each cell (the
    reference's ``slots`` rounds of a scatter-max of (n - index) per cell;
    on CUDA tensors kernel K6, ``splat_kernels.slot_raster_cuda``, gives the
    same ranks and bits). The accumulation order is thereby a pure function
    of the particle set. Particles outside the grid are dropped. Arrays go
    to ``device`` (``placement.on_device``).
    """
    positions, values = on_device(positions, values, device=device)
    n = positions.shape[0]
    rasters, over, meta = slot_raster_cuda(
        positions.contiguous(), None if with_meta else values.contiguous(), grid, slots,
        hsc + 1, slab_ncx, slab_x0, with_meta,
    )
    if with_meta:
        n_over = over.sum()
        return rasters, (int(n_over) if overflow_capacity is None else n_over), meta
    px = [positions[:, d] for d in range(3)]
    if overflow_capacity is None:
        overflow = [px[d][over] for d in range(3)] + [values[over]]
        return rasters, tuple(overflow)
    take = kernels.compact_indices(over, overflow_capacity)
    real = take < n
    take = take.clamp_max(n - 1)
    overflow = [torch.where(real, px[d][take], -1e30) for d in range(3)]
    overflow.append(torch.where(real, values[take], 0.0))
    return rasters, tuple(overflow), over.sum()


def density_weights_from_rasters(
    fx, fy, fz, rank, ok, cx, cy, cz, particle_rest_mass,
    compact_support_radius, grid: UniformGrid, hsc: int, reach: int,
    h_over_cs: float, device=None,
):
    """The value raster for ``sweep_global`` and the per-particle densities
    from the pair sweep over the fraction rasters (the reference's
    ``density_weights_from_rasters``). Exact only when no particle
    overflowed the raster slots: the caller checks the overflow count.

    acc comes from K4 (``pair_sweep_cuda``); fv = m / rho = 1 / (sigma acc)
    on occupied slots and exactly 0 on empty and pad slots, in a zero (S, Xp,
    Yp, Zp) raster; rho = m sigma acc is gathered per particle at (rank, cx,
    cy, cz) where ``ok`` (0 elsewhere), with 64-bit flat indices. Returns
    (fv, rho). Arrays go to ``device`` (``placement.on_device``)."""
    fx, fy, fz, rank, ok, cx, cy, cz = on_device(fx, fy, fz, rank, ok, cx, cy, cz, device=device)
    dtype = fx.dtype
    S, Xp, Yp, Zp = fx.shape
    ncx, ncy, ncz = grid.n_cells
    pad = hsc + 1
    t = kernels.np_dtype(dtype).type
    h = t(compact_support_radius)
    sigma = t(8.0) / (h * h * h)
    acc = pair_sweep_cuda(
        fx, fy, fz, grid.cell_size, compact_support_radius, reach, h_over_cs,
        pad, grid.n_cells,
    )
    inner = (slice(None), slice(pad, pad + ncx), slice(pad, pad + ncy), slice(pad, pad + ncz))
    # empty slots hold the far sentinel (inf / 1e15; an occupied fraction
    # lies within one cell). The kernel writes 0 there, the plain version
    # NaN (f32) or a meaningless finite sum (f64), as the reference does.
    real = (fx[inner] < 1e14) & torch.isfinite(acc) & (acc > 0)
    fv = torch.zeros((S, Xp, Yp, Zp), dtype=dtype, device=fx.device)
    fv[inner] = torch.where(real, 1.0 / (float(sigma) * torch.where(real, acc, 1.0)), 0.0)
    src = ((rank.clamp(0, S - 1) * ncx + cx) * ncy + cy) * ncz + cz
    src = torch.where(ok, src, 0)
    rho = torch.where(ok, float(t(particle_rest_mass) * sigma) * acc.reshape(-1)[src], 0.0)
    return fv, rho


def _scatter_splat_points(opx, opy, opz, oval, grid: UniformGrid, h, hsc,
                          out: torch.Tensor, x0: int):
    """Scatter-add splat of the (few) overflow particles onto ``out``, the
    (PX, PY, PZ) grid points from global x plane ``x0`` on (the whole grid,
    or one slab). Point coordinates stay global, only the flat index is
    relative to ``out``. ``index_add_`` runs with atomics on CUDA, so the
    order of the sums at a point, and its last bits, change from run to
    run."""
    dtype = opx.dtype
    dev = opx.device
    npts = grid.n_points
    local = out.shape
    origin = (x0, 0, 0)
    strides = (npts[1] * npts[2], npts[2], 1)
    out_flat = out.reshape(-1)
    cs = kernels.rounded(grid.cell_size, dtype)
    mn = [kernels.rounded(grid.min[d], dtype) for d in range(3)]
    pxs = (opx, opy, opz)
    cell = [cell_of(pxs[d], mn[d], cs, npts[d]) for d in range(3)]
    offs = _point_offsets(hsc, dev)
    # bound the (particles, offsets) block to ~2^22 entries
    step = max(1, (1 << 22) // offs.shape[0])
    for b in range(0, opx.shape[0], step):
        sl = slice(b, b + step)
        d2 = 0.0
        flat = 0
        in_grid = True
        for d in range(3):
            p = cell[d][sl, None] + offs[None, :, d]  # global point index
            delta = kernels.grid_coord(p, grid.min[d], cs, dtype) - pxs[d][sl, None]
            d2 = d2 + delta * delta
            p = p - origin[d]
            in_grid = in_grid & (p >= 0) & (p < local[d])
            flat = flat + p * strides[d]
        w = kernels.cubic_kernel(torch.sqrt(d2), h) * oval[sl, None]
        # entries off the grid add 0 at a clamped index of their own, so
        # that no single address takes all of their atomics
        out_flat.index_add_(
            0, flat.clamp(0, out_flat.numel() - 1).reshape(-1),
            torch.where(in_grid, w, 0.0).reshape(-1),
        )
    return out


@functools.cache
def _point_offsets(hsc: int, device: torch.device) -> torch.Tensor:
    """``supported_point_offsets(hsc)`` on ``device``, copied there once."""
    return torch.as_tensor(supported_point_offsets(hsc).astype(np.int64), device=device)


def sweep_global(rasters, overflow, grid: UniformGrid, compact_support_radius, hsc: int,
                 slab_npx: Optional[int] = None, slab_x0: Optional[int] = None,
                 device=None):
    """Level set phi on the (PX, PY, PZ) grid points: the dense stencil
    sweep over the rasters (kernel K1 on CUDA, its plain version on the
    CPU) plus the scatter splat of the overflow particles. On one slab (the
    rasters of ``rasterize_global(..., slab_ncx=W, slab_x0=x0)``, and
    ``slab_npx`` = W + 1) the points are the slab's (W + 1, PY, PZ) from
    global plane x0 on; by default all of them. Arrays go to ``device``
    (``placement.on_device``)."""
    both = on_device(*rasters, *overflow, device=device)
    rasters, overflow = both[: len(rasters)], both[len(rasters) :]
    PX, PY, PZ = grid.n_points
    n_points = (PX if slab_npx is None else slab_npx, PY, PZ)
    acc = sweep_global_cuda(
        *rasters, grid.cell_size, compact_support_radius, hsc, n_points
    )
    if overflow[0].shape[0] == 0:
        return acc
    return _scatter_splat_points(*overflow, grid, compact_support_radius, hsc, acc, slab_x0 or 0)


def mc_point_words(ls: torch.Tensor, grid: UniformGrid, iso, x0: int = 0,
                   own_px: Optional[int] = None, capacity: Optional[int] = None):
    """Marching cubes, part (a): the active points of a level set on grid
    points, with their words and edge parameters.

    ``ls`` holds the (PX, PY, PZ) points from global x plane ``x0`` on: the
    whole grid (x0 = 0), or one slab. Each grid point owns its three origin
    edges (+x/+y/+z) and, when it is not on a far boundary plane of the
    global grid, the cell with the same ijk. An 11-bit word per point packs
    the cell's case (bits 0-7, 0 when there is no cell or the cell is all
    inside/outside) and the three edges' activity (bits 8-10). The cell and
    the x edge are tested against the global x, so a slab's words equal the
    whole grid's. With ``own_px``, points of local x >= ``own_px`` are not
    this call's to emit (a slab's far plane: the next slab owns it) and get
    word 0.

    Returns (points, words, t): the active points' global flat ids, int64
    and ascending, their words (int64), and t (3, n_active), the parameter
    of each active point's edge along each axis (meaningless where that
    edge is inactive). Their count is read back; with ``capacity`` nothing
    is: the lists have that fixed size, the entries past the active points
    hold the point id PX * PY * PZ past the last one and word 0, and active
    points past the capacity are cut (the caller checks the count,
    ``_mc_totals``)."""
    dtype = ls.dtype
    dev = ls.device
    PX, PY, PZ = ls.shape
    n_pts = PX * PY * PZ
    iso = kernels.rounded(iso, dtype)
    inside = ls >= iso
    insp = torch.nn.functional.pad(inside.to(torch.uint8), (0, 1, 0, 1, 0, 1))

    def win(oi, oj, ok):
        return insp[oi : oi + PX, oj : oj + PY, ok : ok + PZ]

    base = win(0, 0, 0)
    case = torch.zeros((PX, PY, PZ), dtype=torch.int32, device=dev)
    for c8 in range(8):
        case |= win((c8 >> 2) & 1, (c8 >> 1) & 1, c8 & 1).to(torch.int32) << c8
    # the cell bits are dropped on far-boundary points (they own no cell)
    ii = torch.arange(x0, x0 + PX, device=dev)[:, None, None]  # global x
    jj = torch.arange(PY, device=dev)[None, :, None]
    kk = torch.arange(PZ, device=dev)[None, None, :]
    ends = (grid.n_points[0] - 1, PY - 1, PZ - 1)
    has_cell = (ii < ends[0]) & (jj < ends[1]) & (kk < ends[2])
    word = torch.where(has_cell & (case != 0) & (case != 255), case, 0)
    for a, bit in ((0, 8), (1, 9), (2, 10)):
        nbr = win(int(a == 0), int(a == 1), int(a == 2))
        in_rng = (ii, jj, kk)[a] < ends[a]
        word |= ((base != nbr) & in_rng).to(torch.int32) << bit
    if own_px is not None:
        word = torch.where(ii < x0 + own_px, word, 0)
    word_flat = word.reshape(-1)
    points_c = kernels.compact_indices(word_flat != 0, capacity)  # ascending flat id
    pc = points_c.clamp_max(n_pts - 1)
    words_c = torch.where(points_c < n_pts, word_flat[pc], 0).long()

    ls_flat = ls.reshape(-1)
    v0 = ls_flat[pc]
    nbr = torch.stack([pc + PY * PZ, pc + PZ, pc + 1])
    denom = ls_flat[torch.clamp_max(nbr, n_pts - 1)] - v0
    t = torch.clamp(
        (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
    )
    return points_c + x0 * PY * PZ, words_c, t


def mc_mesh_from_points(points: torch.Tensor, words: torch.Tensor, t: torch.Tensor,
                        grid: UniformGrid, caps: Optional[Tuple[int, int]] = None):
    """Marching cubes, part (b): vertices and triangles from the active
    points of the whole grid (``mc_point_words``, or the merge of every
    slab's, in ascending global id).

    Vertices are axis-major (all x-edge vertices in active-point order, then
    y, then z) and triangles follow the active points, then the case-table
    slots. A triangle corner's vertex belongs to a neighbour point, whose
    rank comes from a binary search over ``points``. Returns vertices (V, 3)
    and triangles (T, 3) int32 on the device: the lists of the reference
    package's unencoded output. Their counts are read back; with ``caps``
    (vertex, triangle capacities, the dense route's MC plan) nothing is:
    the lists have those fixed sizes, valid up to the totals of
    ``_mc_totals(words)`` (the reference's ``mc_global_cells``,
    ``ops/global_sweep.py:674-930``)."""
    dev = points.device
    dtype = t.dtype
    _, PY, PZ = grid.n_points
    cs = kernels.rounded(grid.cell_size, dtype)
    total_c = points.shape[0]
    count_t, tab_t, edge_base, edge_axis = _mc_tables(dev)

    # --- vertex stream: one vertex per active origin edge, axis-major -----
    emask = torch.cat([(words >> b) & 1 for b in (8, 9, 10)]) == 1
    cases_c = words & 0xFF
    counts = count_t[cases_c]
    if caps is None:
        vcap, tcap = torch.stack([emask.sum(), counts.sum()]).tolist()
    else:
        vcap, tcap = caps
    vidx_pos = torch.cumsum(emask, 0) - 1  # vertex id of (axis, rank)
    vslot = kernels.compact_indices(emask, vcap).clamp_max(max(3 * total_c - 1, 0))
    vaxis = vslot // max(total_c, 1)
    p0 = points[vslot - vaxis * total_c]
    t = t.reshape(-1)[vslot]
    vijk = (p0 // (PY * PZ), (p0 // PZ) % PY, p0 % PZ)
    verts = []
    for d in range(3):
        pos = kernels.grid_coord(vijk[d], grid.min[d], cs, dtype)
        verts.append(pos + torch.where(vaxis == d, t, 0.0) * cs)
    vertices = torch.stack(verts, dim=1)

    # --- triangle stream --------------------------------------------------
    # the active point that owns each triangle slot: point p owns the slots
    # [ccum[p] - counts[p], ccum[p])
    ccum = torch.cumsum(counts, 0)
    offsets = ccum - counts
    slot_map = torch.searchsorted(ccum, torch.arange(tcap, device=dev), right=True)
    slot_map = slot_map.clamp_max(max(total_c - 1, 0))
    slot_in_cell = torch.arange(tcap, device=dev) - offsets[slot_map]
    emit = slot_in_cell < counts[slot_map]
    slot_in_cell = slot_in_cell.clamp(0, tab_t.shape[1] - 1)
    acase = cases_c[slot_map]
    tpoint = points[slot_map]
    edge_delta = edge_base[:, 0] * (PY * PZ) + edge_base[:, 1] * PZ + edge_base[:, 2]
    cols = []
    for corner in range(3):
        local = tab_t[acase, slot_in_cell, corner]
        nrank = torch.searchsorted(points, tpoint + edge_delta[local])
        nrank = nrank.clamp_max(max(total_c - 1, 0))
        cols.append(torch.where(emit, vidx_pos[edge_axis[local] * total_c + nrank], 0))
    triangles = torch.stack(cols, dim=1).to(torch.int32)
    return vertices, triangles


@functools.cache
def _mc_tables(device: torch.device):
    """(TRI_COUNT, TRI_TABLE, EDGE_BASE_OFFSET (12, 3), EDGE_AXIS (12,)) as
    int64 tensors on ``device``, copied there once."""
    count_t, tab_t = lut_tensors(device)
    base = torch.as_tensor(lut.EDGE_BASE_OFFSET.astype(np.int64), device=device)
    axis = torch.as_tensor(lut.EDGE_AXIS.astype(np.int64), device=device)
    return count_t, tab_t, base, axis


def _mc_totals(words: torch.Tensor) -> torch.Tensor:
    """(vertices, triangles, active points) of the active points' words, as
    an int64 device tensor (nothing is read back)."""
    count_t = _mc_tables(words.device)[0]
    edges = sum(((words >> b) & 1) for b in (8, 9, 10))
    return torch.stack([edges.sum(), count_t[words & 0xFF].sum(), (words != 0).sum()])


def mc_global_cells(ls, grid: UniformGrid, iso,
                    vertex_capacity: Optional[int] = None,
                    triangle_capacity: Optional[int] = None,
                    encode: bool = False, quant_t: bool = False,
                    own_px: Optional[int] = None, device=None):
    """Cell-list marching cubes over the level set on the whole grid's
    points: ``mc_point_words`` then ``mc_mesh_from_points``, which return
    (vertices, triangles). With both capacities nothing is read back and
    the lists have those sizes (see ``mc_mesh_from_points``); ``own_px`` as
    in ``mc_point_words``.

    With ``encode`` the mesh is not built: returns the reference's encoded
    streams (``encode_points``) ``(t, packed, bincl, total_v, total_t,
    total_c)``, the totals as int64 device scalars, from which the host
    rebuilds the mesh (``decode_encoded``); ``quant_t`` ships t as u16. An
    array goes to ``device`` (``placement.on_device``)."""
    ls = on_device(ls, device=device)
    own_px = None if own_px is None else int(own_px)
    caps = None
    if vertex_capacity is not None and triangle_capacity is not None:
        caps = (vertex_capacity, triangle_capacity)
    points = mc_point_words(
        ls, grid, iso, own_px=own_px, capacity=None if caps is None else caps[1]
    )
    if encode:
        return encode_points(
            *points, ls.numel(), vertex_capacity=None if caps is None else caps[0],
            quant_t=quant_t,
        )
    return mc_mesh_from_points(*points, grid, caps)


# the packed compaction's block width: a point's offset in its block (5
# bits) sits above its 11-bit word, so a packed slot is exactly 16 bits
BLOCK = 32


def encode_points(points: torch.Tensor, words: torch.Tensor, t: torch.Tensor, n_pts: int,
                  x0_points: int = 0, vertex_capacity: Optional[int] = None,
                  quant_t: bool = False):
    """The encoded streams of a level set's active points (the reference's
    ``mc_global_cells(encode=True)``, ``ops/global_sweep.py:808-958``).

    ``points``, ``words``, ``t`` come from ``mc_point_words`` over ``n_pts``
    grid points whose first global flat id is ``x0_points`` (0 for the whole
    grid, x0 * PY * PZ for a slab); past its active points the list may
    hold the pad id ``x0_points + n_pts`` (a capacity). Returns ``(t,
    packed, bincl, total_v, total_t, total_c)``:

    - ``t``: one edge parameter per active edge, axis-major (every active x
      edge in point order, then y, then z), as ``mc_mesh_from_points``
      orders its vertices; u16 (round(t * 65535)) with ``quant_t``, else
      the field's dtype. ``vertex_capacity`` entries (garbage past
      ``total_v``), or exactly ``total_v`` without it;
    - ``packed``: u16 per active point, (its offset in its 32-point block) <<
      11 | word, zero past ``total_c``; as long as ``points``;
    - ``bincl``: u8, the active points of each 32-point block of the
      ``n_pts`` points;
    - ``total_v``, ``total_t``, ``total_c``: int64 device scalars (vertices,
      triangles, active points).

    Nothing is read back when ``points`` has a capacity and
    ``vertex_capacity`` is given."""
    dev = points.device
    cap = points.shape[0]
    local = points - x0_points
    valid = local < n_pts
    packed = torch.where(valid, ((local & (BLOCK - 1)) << 11) | words, 0).to(torch.uint16)
    nb = -(-n_pts // BLOCK)
    blk = torch.where(valid, local // BLOCK, nb)
    bincl = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    bincl.index_add_(0, blk, torch.ones_like(blk, dtype=torch.int32))
    bincl = bincl[:nb].to(torch.uint8)

    emask = torch.cat([(words >> b) & 1 for b in (8, 9, 10)]) == 1
    vslot = kernels.compact_indices(emask, vertex_capacity).clamp_max(max(3 * cap - 1, 0))
    tv = t.reshape(-1)[vslot]
    if quant_t:
        tv = torch.round(tv * 65535.0).to(torch.uint16)
    count_t = _mc_tables(dev)[0]
    totals = (emask.sum(), count_t[words & 0xFF].sum(), valid.sum())
    return (tv, packed, bincl) + totals


def _pack_cellwise(t: torch.Tensor, packed: torch.Tensor, nv: int, nc: int):
    """The encoded streams (t, packed) cut to their copy buckets (or any
    two streams: the packed pull's vertices and triangles)."""
    return t[:nv], packed[:nc]


def _unpack_compact(packed, bcounts, total_c: int, point_offset: int = 0):
    """Numpy inverse of the packed compaction: (points int64, words uint16)
    from the u16 packed stream and the u8 per-block counts (block width
    32), the ids offset by ``point_offset`` (the native ``unpack_compact``
    computes the same)."""
    packed = np.asarray(packed[:total_c]).astype(np.int64)
    counts = np.asarray(bcounts).astype(np.int64)
    blk = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    if len(blk) != total_c:
        raise RuntimeError("packed-compaction decode inconsistency")
    points = blk * BLOCK + (packed >> 11) + point_offset
    words = (packed & 0x7FF).astype(np.uint16)
    return points, words


def _dequant_t(t: np.ndarray) -> np.ndarray:
    """The host inverse of the u16 edge-parameter quantization (other
    streams come back as they are)."""
    if t.dtype == np.uint16:
        return t.astype(np.float32) * np.float32(1.0 / 65535.0)
    return t


def _decode_cellwise_mesh(t, points, words, total_v: int, total_t: int, total_c: int,
                          grid: UniformGrid):
    """The numpy decoder of the point-word streams (the reference's
    ``_decode_cellwise_mesh``, ``ops/global_sweep.py:1062-1134``): the mesh
    of ``mc_mesh_from_points``, up to the multiply-add of the vertex
    positions (the host multiplies, then adds). It runs in the streams'
    dtype, so it is the decoder of f64 streams and of hosts without a
    compiler. Returns (vertices (V, 3), triangles (T, 3) int32)."""
    PY, PZ = grid.n_points[1], grid.n_points[2]
    points = np.asarray(points[:total_c]).astype(np.int64)
    words = np.asarray(words[:total_c]).astype(np.int64)
    t = np.asarray(t[:total_v])
    dtype = t.dtype
    cases = words & 0xFF

    ea = [(words >> 8) & 1, (words >> 9) & 1, (words >> 10) & 1]
    emask = np.concatenate(ea) == 1
    vcum = np.cumsum(emask)
    if total_v and int(vcum[-1]) != total_v:
        raise RuntimeError("cellwise decode inconsistency: vertex count")
    vidx_pos = vcum - 1

    ci = points // (PY * PZ)
    rem = points - ci * (PY * PZ)
    cj = rem // PZ
    ck = rem - cj * PZ
    ijk = np.stack([ci, cj, ck])
    verts = np.empty((total_v, 3), dtype)
    cs = dtype.type(grid.cell_size)
    vo = 0
    for a in range(3):
        sel = ea[a] == 1
        n_a = int(sel.sum())
        ta = t[vo : vo + n_a]
        for d in range(3):
            pos_d = dtype.type(grid.min[d]) + ijk[d][sel].astype(dtype) * cs
            if d == a:
                pos_d = pos_d + ta * cs
            verts[vo : vo + n_a, d] = pos_d
        vo += n_a
    if total_t == 0:
        return verts, np.zeros((0, 3), np.int32)

    # neighbour ranks for the 7 nonzero offsets (the points ascend)
    rank7 = np.empty((8, total_c), np.int64)
    rank7[0] = np.arange(total_c)
    for off in range(1, 8):
        di, dj, dk = (off >> 2) & 1, (off >> 1) & 1, off & 1
        target = points + (di * (PY * PZ) + dj * PZ + dk)
        pos = np.searchsorted(points, target)
        posc = np.minimum(pos, total_c - 1)
        rank7[off] = np.where(points[posc] == target, posc, -1)

    counts = lut.TRI_COUNT[cases].astype(np.int64)
    rep = np.repeat(np.arange(total_c, dtype=np.int64), counts)
    if len(rep) != total_t:
        raise RuntimeError("cellwise decode inconsistency: triangle count")
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(rep), dtype=np.int64) - starts[rep]
    tri_tab = np.where(lut.TRI_TABLE >= 0, lut.TRI_TABLE, 0)
    eb = lut.EDGE_BASE_OFFSET.astype(np.int64)
    eax = lut.EDGE_AXIS.astype(np.int64)
    off_idx_tab = eb[:, 0] * 4 + eb[:, 1] * 2 + eb[:, 2]
    tris = np.empty((total_t, 3), np.int32)
    for corner in range(3):
        local = tri_tab[cases[rep], slot, corner]
        rank = rank7[off_idx_tab[local], rep]
        if (rank < 0).any():
            raise RuntimeError("cellwise decode inconsistency: missing owner")
        tris[:, corner] = vidx_pos[eax[local] * total_c + rank].astype(np.int32)
    return verts, tris


def decode_encoded(t, packed, bincl, total_v: int, total_t: int, total_c: int,
                   grid: UniformGrid, point_offset: int = 0):
    """The host mesh of host copies of ``encode_points``' streams (numpy
    arrays): the native decoder (``native.mc_decode``) for f32 and u16
    streams, the numpy one (``_decode_cellwise_mesh``) for f64 streams or
    where the native library cannot be built, as the reference chooses.
    Returns (vertices (V, 3), triangles (T, 3) int32) numpy arrays."""
    pw = unpack_points(t, packed, bincl, total_c, point_offset)
    return decode_encoded_points(t, *pw, total_v, total_t, total_c, grid)


def unpack_points(t, packed, bincl, total_c: int, point_offset: int = 0):
    """(points int64, words) of a packed stream whose edge parameters are
    ``t``: the native ``unpack_compact`` beside f32 and u16 t, numpy beside
    f64 t or where the native library cannot be built."""
    from splashsurf_tpu_torch import native

    pw = None
    if np.asarray(t).dtype != np.float64:
        pw = native.unpack_compact(packed, bincl, total_c, point_offset)
    return pw if pw is not None else _unpack_compact(packed, bincl, total_c, point_offset)


def decode_encoded_points(t, points, words, total_v: int, total_t: int, total_c: int,
                          grid: UniformGrid):
    """The host mesh of unpacked point-word streams: (t, int64 points,
    words) numpy arrays. The native decoder for f32 and u16 t, the numpy
    one for f64 t or where the native library cannot be built; both
    counted in ``native.DECODE_STATS``."""
    from splashsurf_tpu_torch import native

    t = _dequant_t(np.asarray(t))
    dec = None
    if t.dtype == np.float32:
        dec = native.mc_decode(t, points, words, total_v, total_t, total_c,
                               grid.n_points[1], grid.n_points[2], grid.min, grid.cell_size)
    if dec is None:
        native.DECODE_STATS["numpy"] += 1
        dec = _decode_cellwise_mesh(t, points, words, total_v, total_t, total_c, grid)
    return dec


def mc_global_packed(ls, grid: UniformGrid, iso,
                     vertex_capacity: Optional[int] = None,
                     triangle_capacity: Optional[int] = None, encode: bool = False,
                     device=None):
    """Edge-major marching cubes over the whole grid (the reference's
    ``mc_global_packed``, ``ops/global_sweep.py:516-667``; reached through
    ``SPLASHSURF_TPU_MC=edges``): the active edges of the three dense edge
    masks are compacted (vertex v is the v-th active edge in ``edge_layout``
    order), the active cells by their triangle counts, and a triangle
    corner's vertex is the rank of its global edge in the active-edge list.

    Returns (vertices (V, 3), triangles (T, 3) int32, total_v, total_t),
    the totals as int64 device scalars; with ``encode``, the reference's
    encoded streams ``(active_edge, t, cells, cases, total_v, total_t,
    total_c)`` instead (active edge ids and their t, active cell ids and
    their u8 cases), decoded on the host by ``_decode_packed_mesh``. With
    both capacities the lists have those sizes (zero-filled past the
    totals, as the reference's) and nothing is read back; without them,
    their exact sizes. An array goes to ``device`` (``placement.on_device``)."""
    ls = on_device(ls, device=device)
    dtype, dev = ls.dtype, ls.device
    PX, PY, PZ = ls.shape
    iso = kernels.rounded(iso, dtype)
    cs = kernels.rounded(grid.cell_size, dtype)
    inside = ls >= iso
    ls_flat = ls.reshape(-1)
    count_t, tab_t, _, _ = _mc_tables(dev)

    masks = []
    for a in range(3):
        lo = tuple(slice(0, -1) if d == a else slice(None) for d in range(3))
        hi = tuple(slice(1, None) if d == a else slice(None) for d in range(3))
        masks.append((inside[lo] != inside[hi]).reshape(-1))
    mask = torch.cat(masks)
    n_edges = mask.shape[0]
    vidx = torch.cumsum(mask, 0) - 1
    total_v = mask.sum()
    ae = kernels.compact_indices(mask, vertex_capacity)
    ae = torch.where(ae < n_edges, ae, 0)
    # the inverse of edge_layout's x, y, z concatenation, with host scalars
    # only (no copy to the card on a warm frame)
    _, strides, offs, _ = edge_layout((PX, PY, PZ))
    axis = (ae >= offs[1]).long() + (ae >= offs[2]).long()
    pick = lambda v: torch.where(axis == 0, v[0], torch.where(axis == 1, v[1], v[2]))
    local = ae - pick(offs)
    s0, s1 = pick([st[0] for st in strides]), pick([st[1] for st in strides])
    i = local // s0
    rem = local - i * s0
    ijk = torch.stack([i, rem // s1, rem % s1], dim=1)
    p0 = (ijk[:, 0] * PY + ijk[:, 1]) * PZ + ijk[:, 2]
    step = torch.where(axis == 0, PY * PZ, torch.where(axis == 1, PZ, 1))
    v0 = ls_flat[p0]
    denom = ls_flat[(p0 + step).clamp_max(ls_flat.numel() - 1)] - v0
    t = torch.clamp(
        (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
    )

    case_flat = _case_indices(inside).reshape(-1).long()
    counts = count_t[case_flat]
    ccum = torch.cumsum(counts, 0)
    total_t = ccum[-1] if ccum.numel() else counts.sum()
    if encode:
        active = counts > 0
        cells = kernels.compact_indices(active, triangle_capacity)
        cells = torch.where(cells < case_flat.numel(), cells, 0)
        cases = torch.where(
            torch.arange(cells.shape[0], device=dev) < active.sum(), case_flat[cells], 0
        ).to(torch.uint8)
        return ae, t, cells, cases, total_v, total_t, active.sum()

    verts = []
    for d in range(3):
        pos = kernels.grid_coord(ijk[:, d], grid.min[d], cs, dtype)
        verts.append(pos + torch.where(axis == d, t, 0.0) * cs)
    vertices = torch.stack(verts, dim=1)

    tcap = int(total_t) if triangle_capacity is None else triangle_capacity
    n_cells = case_flat.numel()
    offsets = ccum - counts
    cell = torch.searchsorted(ccum, torch.arange(tcap, device=dev), right=True)
    cell = cell.clamp_max(max(n_cells - 1, 0))
    slot_in_cell = torch.arange(tcap, device=dev) - offsets[cell]
    emit = slot_in_cell < counts[cell]
    slot_in_cell = slot_in_cell.clamp(0, tab_t.shape[1] - 1)
    acase = case_flat[cell]
    cy, cz = PY - 1, PZ - 1
    cijk = (cell // (cy * cz), (cell // cz) % cy, cell % cz)
    coeffs = _edge_coeff_tensors((PX, PY, PZ), dev)
    cols = []
    for corner in range(3):
        local = tab_t[acase, slot_in_cell, corner]
        edge = (coeffs[0][local] + coeffs[1][local] * cijk[0] + coeffs[2][local] * cijk[1]
                + coeffs[3][local] * cijk[2])
        cols.append(torch.where(emit, vidx[edge], 0))
    return vertices, torch.stack(cols, dim=1).to(torch.int32), total_v, total_t


@functools.cache
def _edge_coeff_tensors(n_points: Tuple[int, int, int], device: torch.device):
    """``_local_edge_coeffs(n_points)`` as int64 tensors on ``device``,
    copied there once."""
    return [torch.as_tensor(c, device=device) for c in _local_edge_coeffs(n_points)]


def _pack_encoded(ae, t, cells, cases, nv: int, nc: int):
    """The edge-major encoded streams cut to their copy buckets."""
    return ae[:nv], t[:nv], cells[:nc], cases[:nc]


def _decode_packed_mesh(ae, t, cells, cases, total_v: int, total_t: int, total_c: int,
                        grid: UniformGrid):
    """The numpy decoder of ``mc_global_packed``'s encoded streams (the
    reference's ``_decode_packed_mesh``, ``ops/global_sweep.py:1137-1193``):
    vertex positions from (edge id, t), triangle corners as the rank of
    their global edge among the ascending active edges. Returns (vertices
    (V, 3), triangles (T, 3) int32)."""
    n_points = grid.n_points
    _shapes, strides, offs, _total = edge_layout(n_points)
    ae = np.asarray(ae[:total_v]).astype(np.int64)
    t = np.asarray(t[:total_v])
    axis = np.where(ae >= offs[2], 2, np.where(ae >= offs[1], 1, 0))
    ijk = np.zeros((total_v, 3), np.int64)
    for a in range(3):
        la = ae - offs[a]
        s0, s1, _ = strides[a]
        ia = la // s0
        ra = la - ia * s0
        sel = axis == a
        ijk[sel, 0] = ia[sel]
        ijk[sel, 1] = (ra // s1)[sel]
        ijk[sel, 2] = (ra - (ra // s1) * s1)[sel]
    dtype = t.dtype
    cs = dtype.type(grid.cell_size)
    verts = np.empty((total_v, 3), dtype)
    for d in range(3):
        pos_d = dtype.type(grid.min[d]) + ijk[:, d].astype(dtype) * cs
        verts[:, d] = pos_d + np.where(axis == d, t, dtype.type(0)) * cs
    if total_v == 0 or total_t == 0:
        return verts[:0], np.zeros((0, 3), np.int32)

    cells = np.asarray(cells[:total_c]).astype(np.int64)
    cases = np.asarray(cases[:total_c]).astype(np.int64)
    counts = lut.TRI_COUNT[cases].astype(np.int64)
    rep = np.repeat(np.arange(total_c, dtype=np.int64), counts)
    if len(rep) != total_t:
        raise RuntimeError("edge-major decode inconsistency: triangle count")
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(rep), dtype=np.int64) - starts[rep]
    cy, cz = n_points[1] - 1, n_points[2] - 1
    ci = cells // (cy * cz)
    cj = (cells // cz) % cy
    ck = cells % cz
    const, ci_c, cj_c, ck_c = _local_edge_coeffs(n_points)
    tris = np.empty((total_t, 3), np.int32)
    tri_tab = np.where(lut.TRI_TABLE >= 0, lut.TRI_TABLE, 0)
    for corner in range(3):
        local = tri_tab[cases[rep], slot, corner]
        edge_flat = (const[local] + ci_c[local] * ci[rep] + cj_c[local] * cj[rep]
                     + ck_c[local] * ck[rep])
        tris[:, corner] = np.searchsorted(ae, edge_flat).astype(np.int32)
    return verts, tris


class EmptyFieldError(RuntimeError):
    """An empty mesh came out although the level set says it should not
    have: the field is NaN, identically zero despite particles, or reaches
    the threshold."""


def check_empty_field(total_t: int, ls_max: float, iso: float) -> None:
    """Contract guard for empty meshes (see EmptyFieldError)."""
    if total_t > 0:
        return
    if np.isnan(ls_max):
        raise EmptyFieldError("empty mesh and the level set contains NaN")
    if ls_max == 0.0:
        raise EmptyFieldError(
            "empty mesh and the level set is identically zero despite input "
            "particles: the density splat produced no field"
        )
    if ls_max >= iso:
        raise EmptyFieldError(
            f"empty mesh but the level set reaches {ls_max:.6g} >= iso={iso:.6g}: "
            "marching cubes dropped the surface"
        )


class SpeculationMiss(RuntimeError):
    """One of the caller's deferred checks came back False; ``flags`` holds
    each check's value, in the order they were passed."""

    def __init__(self, flags):
        super().__init__(f"speculative plan violated: {flags}")
        self.flags = tuple(flags)


def pack_parts(arrs):
    """Tensors of one device packed into one uint8 tensor, each part
    8-byte aligned, and its layout: per part (dtype, shape, bytes), which
    ``unpack_parts`` takes back apart."""
    chunks, layout = [], []
    for p in arrs:
        b = p.contiguous().reshape(-1).view(torch.uint8)
        layout.append((p.dtype, tuple(p.shape), b.numel()))
        chunks.append(b)
        if b.numel() % 8:
            chunks.append(b.new_zeros(8 - b.numel() % 8))
    return torch.cat(chunks), layout


def unpack_parts(buf: torch.Tensor, layout) -> list:
    """Views of the parts of a ``pack_parts`` buffer (or a copy of it)."""
    out, o = [], 0
    for dtype, shape, nb in layout:
        out.append(buf[o : o + nb].view(dtype).reshape(shape))
        o += -(-nb // 8) * 8
    return out


class PendingPull:
    """A dense frame's mesh on its way to the host (reference
    ``PendingPull``, ``ops/global_sweep.py:1372-1395``).

    The copy of ``arrs`` (device tensors) starts when the object is made.
    On CUDA they are packed into one byte buffer, which is copied,
    non-blocking, into pinned host memory on a side stream, after the
    current stream's work up to now: the copy overlaps whatever the caller
    queues next, and the device buffer stays referenced until it ends. On
    the CPU there is nothing to copy. ``resolve()`` waits for the copy and
    hands the host copies of ``arrs`` to ``fn``, which returns ``("ok",
    vertices, triangles)`` as host tensors, or ``("redo",)`` /
    ``("redo_grid",)`` where a deferred check failed and the frame must run
    again. The pack and the copy's start, and the wait, are "mesh pull"
    spans; the wait, on any device, is one read-back."""

    def __init__(self, fn, arrs):
        self._fn = fn
        self._event = None
        self._host = list(arrs)
        self._unread = bool(arrs)
        if not arrs or arrs[0].device.type != "cuda":
            return
        dev = arrs[0].device
        with profile("mesh pull"):
            buf, self._layout = pack_parts(arrs)
            stream = _copy_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._buf = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
                self._buf.copy_(buf, non_blocking=True)
                buf.record_stream(stream)
                self._event = torch.cuda.Event()
                self._event.record(stream)

    def host_parts(self):
        """The parts on the host (waits for the copy)."""
        if self._unread:
            self._unread = False
            with profile("mesh pull"), read_back():
                if self._event is not None:
                    self._event.synchronize()
                    self._event = None
                    self._host = unpack_parts(self._buf, self._layout)
        return self._host

    def resolve(self):
        return self._fn(*self.host_parts())


@functools.cache
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for the mesh copies."""
    return torch.cuda.Stream(device=device)


def reconstruct_global_dense(
    positions, values, grid: UniformGrid, compact_support_radius: float,
    hsc: int, iso: float, slots: int = 2, deferred_checks: tuple = (),
    defer_pull: bool = False, check_labels: tuple = (), device=None,
):
    """Full dense-grid reconstruction on the positions' device (reference
    ``ops/global_sweep.py:1196-1285``). Returns (vertices (V, 3), triangles
    (T, 3) int32) on the host, as CPU tensors.

    The frame runs on the overflow plan of its (grid, N), by default N / 64
    rounded up to a power of two (at least 4096), and on the MC and pull
    plans of its (grid, dtype) (``_finish_global_dense``); a raster
    overflow past the plan's capacity grows the plan and rasterizes again,
    in a "redo overflow" span. The stages are the spans "dense raster" and
    "dense level set", and those of ``_finish_global_dense``.
    ``deferred_checks`` (device bools, such as the density and grid plans'
    checks, named by ``check_labels``) come back with the mesh totals; a
    False one raises :class:`SpeculationMiss`. With ``defer_pull`` returns
    a :class:`PendingPull` instead, whose ``resolve()`` validates the plans
    and checks as the reference's does and reports a miss as a redo. Arrays
    go to ``device`` (``placement.on_device``).
    """
    positions, values = on_device(positions, values, device=device)
    n = positions.shape[0]
    okey = (grid.n_points, n)
    ocap = plans.overflow_capacity(okey, n)
    for attempt in range(4):
        with redo_span("overflow", attempt):
            with profile("dense raster"):
                rasters, overflow, n_over = rasterize_global(
                    positions, values, grid, slots, hsc, ocap
                )
                if okey not in plans.OVER_PLAN:
                    # no plan yet: this frame reads counts back anyway, so it
                    # splats the real rows only (the sums are those of the
                    # whole list)
                    real = int(to_host(n_over))
                    overflow = tuple(c[:real] for c in overflow)
            with profile("dense level set"):
                ls = sweep_global(rasters, overflow, grid, compact_support_radius, hsc)
            del rasters, overflow
            out = _finish_global_dense(
                ls, grid, iso, okey, ocap, n_over, deferred_checks, defer_pull, check_labels,
                over_max=plans.pow2(n),
            )
            if out is not None:
                return out if defer_pull else out.resolve()[1:]
            # the level set misses the dropped overflow splats: the plan has grown
            ocap = plans.OVER_PLAN[okey]
    raise RuntimeError(f"raster overflow exceeded capacity {ocap} after retries")


def pull_mode(dtype: torch.dtype) -> Tuple[bool, bool, bool]:
    """(edges, encoded, quant_t) of a dense frame in ``dtype``, from the
    reference's switches, read at each call (its ``ops/global_sweep.py:
    1410-1425``): ``SPLASHSURF_TPU_MC`` "edges" takes the edge-major
    ``mc_global_packed`` (default "cells", ``mc_global_cells``) and forces
    the packed pull; ``SPLASHSURF_TPU_PULL`` "encoded" ships the encoded
    streams and decodes on the host (the port's default is "packed", the
    mesh itself: the reference's default is "encoded"); and
    ``SPLASHSURF_TPU_PULL_QUANT`` "1" (the default) ships an encoded f32
    pull's t as u16 (``pull_quant``)."""
    edges = os.environ.get("SPLASHSURF_TPU_MC", "cells") == "edges"
    encoded = not edges and os.environ.get("SPLASHSURF_TPU_PULL", "packed") == "encoded"
    return edges, encoded, encoded and pull_quant(dtype)


def pull_quant(dtype: torch.dtype) -> bool:
    """Whether an encoded pull in ``dtype`` ships t as u16:
    ``SPLASHSURF_TPU_PULL_QUANT`` "1" (the default) and f32."""
    return dtype == torch.float32 and os.environ.get("SPLASHSURF_TPU_PULL_QUANT", "1") == "1"


# Facts about the last dense mesh pull, read by tests and chip_smoke.py,
# never by the pipeline: "mode" ("packed", "encoded" or "edges"), "bytes"
# (copied to the host, in the last copy of the mesh) and "decode_s" (host
# seconds of the encoded decode, 0 for the packed pulls).
LAST_PULL: dict = {}


class _MeshStreams:
    """What a dense frame copies to the host: two streams cut to (vertex,
    second) buckets, the second counted in triangles (packed pulls) or
    active points (encoded), plus whole extra parts (the encoded per-block
    counts), and how the host copies become the mesh."""

    def __init__(self, mode, streams, extra, second, grid):
        self.mode, self.streams, self.extra, self.second = mode, streams, extra, second
        self.grid = grid

    def parts(self, nv: int, n2: int):
        return list(_pack_cellwise(*self.streams, nv, n2)) + self.extra

    def mesh(self, host, total_v: int, total_t: int, total_c: int):
        """("ok", vertices, triangles) as host tensors from the host copies
        of ``parts``; ``LAST_PULL`` records the copy."""
        LAST_PULL.update(mode=self.mode, bytes=sum(h.numel() * h.element_size() for h in host),
                         decode_s=0.0)
        if self.mode != "encoded":
            return ("ok", host[0][:total_v], host[1][:total_t])
        t0 = time.perf_counter()
        v, tr = decode_encoded(*(h.numpy() for h in host), total_v, total_t, total_c, self.grid)
        LAST_PULL["decode_s"] = time.perf_counter() - t0
        return ("ok", torch.from_numpy(v), torch.from_numpy(tr))


def _dense_mc(ls, grid: UniformGrid, iso, caps):
    """Marching cubes of a dense frame in the mode ``pull_mode`` reads: its
    ``_MeshStreams`` and its totals (vertices, triangles, active points; 0
    active points on the edge-major path), an int64 device tensor. Without
    ``caps`` the streams have their exact sizes."""
    edges, encoded, quant = pull_mode(ls.dtype)
    vcap, tcap = (None, None) if caps is None else caps
    if edges:
        verts, tris, total_v, total_t = mc_global_packed(ls, grid, iso, vcap, tcap)
        totals = torch.stack([total_v, total_t, torch.zeros_like(total_v)])
        return _MeshStreams("edges", (verts, tris), [], 1, grid), totals
    points, words, t = mc_point_words(ls, grid, iso, capacity=tcap)
    if encoded:
        tv, packed, bincl, *totals = encode_points(
            points, words, t, ls.numel(), vertex_capacity=vcap, quant_t=quant
        )
        return _MeshStreams("encoded", (tv, packed), [bincl], 2, grid), torch.stack(totals)
    verts, tris = mc_mesh_from_points(points, words, t, grid, caps)
    return _MeshStreams("packed", (verts, tris), [], 1, grid), _mc_totals(words)


def _finish_global_dense(ls, grid: UniformGrid, iso, okey, overflow_capacity, n_over,
                         deferred_checks=(), defer_pull=False, check_labels=(),
                         over_max=None):
    """Marching cubes and the mesh copy of a dense frame (reference
    ``ops/global_sweep.py:1397-1565``), in the mode of ``pull_mode``: the
    packed pull copies the mesh; the encoded pull copies the streams of
    ``encode_points`` and decodes them on the host at resolve.

    The planning frame of a (grid, dtype) runs MC on lists of exact size
    (their counts read back) and plans the MC capacities from them. A frame
    with capacities writes into buffers of them. With a pull plan too
    (``plans.PULL_PLAN``, or ``plans.PULL_PLAN_ENC`` for the encoded pull, whose
    second bucket counts active points, not triangles), it cuts the streams
    to the plan's buckets and copies them together with their totals, the
    overflow count, the level set's maximum and the deferred checks, in one
    copy (``PendingPull``); without one it reads those scalars first, then
    copies the exact streams.

    Returns a :class:`PendingPull`, or None when the frame's raster overflow
    exceeded ``overflow_capacity``: the overflow plan has grown (to at most
    ``over_max``) and the caller rasterizes again. With ``defer_pull`` on a
    frame with every plan, the returned pull has not been read: its
    ``resolve()`` runs the checks below, updates the plans on a miss
    exactly as they do, and reports the miss as a redo. Otherwise the
    checks run here: a False deferred check raises
    :class:`SpeculationMiss`, and then ``_check_plans``: an MC total past
    its capacity grows the capacities and runs MC again (``caps_retry``, in
    a "redo caps" span); a stream past its bucket is copied again at its
    exact size. Marching cubes and the streams' cut are the span "dense
    mc"; the copy is ``PendingPull``'s "mesh pull".
    """
    iso = kernels.rounded(iso, ls.dtype)
    key = (grid.n_points, str(ls.dtype))
    f64 = lambda x: x.reshape(1).to(torch.float64)
    tail = [f64(n_over), f64(ls.max())] + [f64(c) for c in deferred_checks]
    for attempt in itertools.count():
        with redo_span("caps", attempt):
            with profile("dense mc"):
                caps = plans.MC_CAPS.get(key)
                streams, totals = _dense_mc(ls, grid, iso, caps)
                if caps is None:
                    caps = plans.plan_mc_caps(key, *to_host(totals[:2]).tolist())
                vcap, tcap = caps
                scalars = torch.cat([totals.to(torch.float64)] + tail)
                plan = plans.pull_plans(streams.mode == "encoded").get(key)
                planned = plan is not None and plan[0] <= vcap and plan[1] <= tcap
                if planned:
                    pull_parts = [scalars] + streams.parts(*plan)
            if planned:
                if defer_pull:
                    return PendingPull(functools.partial(
                        _resolve_deferred, streams=streams, iso=iso, caps=caps, key=key,
                        okey=okey, overflow_capacity=overflow_capacity,
                        check_labels=check_labels,
                    ), pull_parts)
                sc, *host = PendingPull(None, pull_parts).host_parts()
            else:
                sc, host = to_host(scalars), None
            flags = sc[5:].tolist()
            if not all(flags):
                raise SpeculationMiss([bool(f) for f in flags])
            outcome, (total_v, total_t, total_c, n2) = _check_plans(
                sc, okey=okey, ocap=overflow_capacity, key=key, caps=caps,
                encoded=streams.mode == "encoded", second=streams.second, iso=iso,
                pulled=None if host is None else (host[0].shape[0], host[1].shape[0]),
                over_max=over_max,
            )
            if outcome == "overflow":
                return None
            if outcome == "caps":
                continue
            if outcome == "bucket":
                exact = streams.parts(total_v, n2)
                return PendingPull(lambda *h: streams.mesh(h, total_v, total_t, total_c), exact)
            return PendingPull(lambda: streams.mesh(host, total_v, total_t, total_c), [])


def _check_plans(sc, *, second, iso, **plan_args):
    """The plan checks of a dense frame on its pulled scalars ``sc``
    (vertices, triangles and active points, the raster overflow count and
    the level set's maximum first): ``plans.check_dense``, which re-plans
    on a miss, with ``plan_args``; where it finds none, an empty mesh is
    checked (``check_empty_field``). ``second`` indexes the totals of the
    stream that the second bucket counts. Returns (outcome, (vertices,
    triangles, active points, the second bucket's total))."""
    total_v, total_t, total_c, total_over, ls_max = sc[:5].tolist()
    total_v, total_t, total_c, total_over = (
        int(x) for x in (total_v, total_t, total_c, total_over)
    )
    n2 = (total_v, total_t, total_c)[second]
    outcome = plans.check_dense((total_v, total_t, total_c, n2, total_over), **plan_args)
    if outcome in ("ok", "bucket") and total_t == 0:
        check_empty_field(0, ls_max, iso)
    return outcome, (total_v, total_t, total_c, n2)


def _resolve_deferred(sc, *host, streams, iso, caps, key, okey, overflow_capacity,
                      check_labels):
    """The checks of a deferred warm frame on its pulled scalars (reference
    ``_defer_encoded_pull``'s resolver, ``ops/global_sweep.py:1306-1359``):
    a miss updates the plan it concerns and returns ``("redo",)``, or
    ``("redo_grid",)`` for the grid; otherwise ``("ok", vertices,
    triangles)``, decoded on the host where the pull is encoded."""
    missed = plans.note_failed_check(check_labels, sc[5:].tolist())
    if missed is not None:
        return ("redo_grid",) if missed == "grid" else ("redo",)
    outcome, (total_v, total_t, total_c, n2) = _check_plans(
        sc, okey=okey, ocap=overflow_capacity, key=key, caps=caps,
        encoded=streams.mode == "encoded", second=streams.second, iso=iso,
        pulled=(host[0].shape[0], host[1].shape[0]),
    )
    if outcome in ("overflow", "caps"):
        return ("redo",)
    if outcome == "bucket":
        # copy the exact streams (one more read)
        host = PendingPull(None, streams.parts(total_v, n2)).host_parts()
    return streams.mesh(host, total_v, total_t, total_c)
