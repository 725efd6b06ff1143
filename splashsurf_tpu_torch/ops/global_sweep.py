"""Dense global reconstruction: raster splat + cell-list marching cubes on
the full background grid (PyTorch port of the dense path of
``splashsurf_tpu.ops.global_sweep``).

Pipeline:
  1. ``rasterize_global`` - particles -> per-cell slot rasters of cell
     fractions and weights, plus the overflow list (cells with more
     particles than slots); on the cell-raster densities, the fraction
     rasters and per-particle slot meta, from which
     ``density_weights_from_rasters`` (kernel K4) makes the weights and the
     densities;
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
reference): the raster overflow list has a planned capacity
(``_OVER_PLAN``), marching cubes writes into buffers of planned vertex and
triangle capacities (``_MC_CAPS``), and the mesh comes to the host in
planned buckets (``_PULL_PLAN``), together with the totals and the caller's
deferred checks, in one copy (``PendingPull``). A frame whose plans are all
in place reads nothing back before that copy; a check that fails there is a
miss, which updates the plans as the reference does and re-runs the frame.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.density import supported_point_offsets
from splashsurf_tpu_torch.mc import lut
from splashsurf_tpu_torch.mc.dense import lut_tensors
from splashsurf_tpu_torch.ops.splat_kernels import pair_sweep_cuda, sweep_global_cuda
from splashsurf_tpu_torch.uniform_grid import UniformGrid


def _cell_of(px: torch.Tensor, mn: float, cs: float, n: int) -> torch.Tensor:
    """floor((x - mn) / cs) as int64, clamped to [-1, n] before the integer
    conversion (in-range values are unchanged)."""
    return torch.floor((px - mn) / cs).clamp(-1, n).to(torch.int64)


def rasterize_global(positions, values, grid: UniformGrid, slots: int, hsc: int,
                     overflow_capacity: Optional[int] = None, with_meta: bool = False,
                     slab_ncx: Optional[int] = None, slab_x0: Optional[int] = None):
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

    Slot ranks follow ascending particle index within each cell: ``slots``
    rounds of a scatter-max of (n - index) per cell pick the next-smallest
    index each round. The accumulation order is thereby a pure function of
    the particle set. Particles outside the grid are dropped.
    """
    dtype = positions.dtype
    dev = positions.device
    n = positions.shape[0]
    ncx, ncy, ncz = grid.n_cells
    pad = hsc + 1
    W = ncx if slab_ncx is None else slab_ncx
    slab_x0 = slab_x0 or 0
    Xp, Yp, Zp = W + 2 * pad, ncy + 2 * pad, ncz + 2 * pad
    cs = kernels.rounded(grid.cell_size, dtype)
    mn = [kernels.rounded(grid.min[d], dtype) for d in range(3)]
    px = [positions[:, d] for d in range(3)]
    cell = [_cell_of(px[d], mn[d], cs, nc) for d, nc in enumerate(grid.n_cells)]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for d, nc in enumerate(grid.n_cells):
        valid &= (cell[d] >= 0) & (cell[d] < nc)
    tx = cell[0] - slab_x0 + pad  # x in the table
    valid &= (tx >= 0) & (tx < Xp)  # the band, halos included (the whole grid by default)
    ncells = Xp * ncy * ncz  # the rank space covers the band
    cflat = torch.where(valid, (tx * ncy + cell[1]) * ncz + cell[2], ncells)

    rank = torch.full((n,), slots, dtype=torch.int64, device=dev)
    remaining = valid
    key = n - torch.arange(n, device=dev)  # ascending index -> descending key
    for r in range(slots):
        tbl = torch.zeros(ncells + 1, dtype=torch.int64, device=dev)
        tbl.scatter_reduce_(
            0, torch.where(remaining, cflat, ncells), key, reduce="amax"
        )
        won = remaining & (tbl[cflat] == key)
        rank = torch.where(won, r, rank)
        remaining = remaining & ~won

    ok = valid & (rank < slots)
    total = slots * Xp * Yp * Zp
    dest = ((rank * Xp + tx) * Yp + cell[1] + pad) * Zp + cell[2] + pad
    dest = torch.where(ok, dest, total)

    shape = (slots, Xp, Yp, Zp)
    far = kernels.far_fill(dtype)
    fracs = tuple(
        kernels.scatter_table(
            dest, px[d] - kernels.grid_coord(cell[d], grid.min[d], cs, dtype),
            total, far, shape,
        )
        for d in range(3)
    )
    over = valid & (rank >= slots)
    if with_meta:
        n_over = over.sum()
        return fracs, (int(n_over) if overflow_capacity is None else n_over), (rank, ok, *cell)
    rasters = fracs + (kernels.scatter_table(dest, values, total, 0.0, shape),)
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
    h_over_cs: float,
):
    """The value raster for ``sweep_global`` and the per-particle densities
    from the pair sweep over the fraction rasters (the reference's
    ``density_weights_from_rasters``). Exact only when no particle
    overflowed the raster slots: the caller checks the overflow count.

    acc comes from K4 (``pair_sweep_cuda``); fv = m / rho = 1 / (sigma acc)
    on occupied slots and exactly 0 on empty and pad slots, in a zero (S, Xp,
    Yp, Zp) raster; rho = m sigma acc is gathered per particle at (rank, cx,
    cy, cz) where ``ok`` (0 elsewhere), with 64-bit flat indices. Returns
    (fv, rho)."""
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
    cell = [_cell_of(pxs[d], mn[d], cs, npts[d]) for d in range(3)]
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
                 slab_npx: Optional[int] = None, slab_x0: Optional[int] = None):
    """Level set phi on the (PX, PY, PZ) grid points: the dense stencil
    sweep over the rasters (kernel K1 on CUDA, its plain version on the
    CPU) plus the scatter splat of the overflow particles. On one slab (the
    rasters of ``rasterize_global(..., slab_ncx=W, slab_x0=x0)``, and
    ``slab_npx`` = W + 1) the points are the slab's (W + 1, PY, PZ) from
    global plane x0 on; by default all of them."""
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


def mc_global_cells(ls: torch.Tensor, grid: UniformGrid, iso,
                    vertex_capacity: Optional[int] = None,
                    triangle_capacity: Optional[int] = None,
                    own_px: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-list marching cubes over the level set on the whole grid's
    points: ``mc_point_words`` then ``mc_mesh_from_points``. With both
    capacities nothing is read back and the lists have those sizes (see
    ``mc_mesh_from_points``); ``own_px`` as in ``mc_point_words``."""
    caps = None
    if vertex_capacity is not None and triangle_capacity is not None:
        caps = (vertex_capacity, triangle_capacity)
    points = mc_point_words(
        ls, grid, iso, own_px=own_px, capacity=None if caps is None else caps[1]
    )
    return mc_mesh_from_points(*points, grid, caps)


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


def _pow2(n: int, lo: int = 1024) -> int:
    return max(lo, 1 << (max(int(n), 1) - 1).bit_length())


def _bucket16(n: int, lo: int = 1024) -> int:
    """Round up to 16 steps per power of two (<= 6% of padding)."""
    n = max(int(n), lo)
    p = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // p) * p


# The dense route's speculative plans (reference ``ops/global_sweep.py:
# 937-958``), process-global as the reference's are:
# per (grid points, dtype), the MC vertex and triangle capacities ...
_MC_CAPS: dict = {}
# ... and the (vertex, triangle) buckets of the mesh copy; per (grid
# points, N), the raster overflow capacity, fitted to the previous frame's
# count (usually 0, which skips the overflow splat).
_PULL_PLAN: dict = {}
_OVER_PLAN: dict = {}
# the overflow count of the last frame that ran past its plan, for the retry
_LAST_OVERFLOW = [0]


def _note_overflow_plan(okey, total_over: int) -> None:
    """Fit the next frame's overflow capacity to this frame's true count."""
    _OVER_PLAN[okey] = 0 if total_over == 0 else _pow2(total_over * 2, lo=1024)


class SpeculationMiss(RuntimeError):
    """One of the caller's deferred checks came back False; ``flags`` holds
    each check's value, in the order they were passed."""

    def __init__(self, flags):
        super().__init__(f"speculative plan violated: {flags}")
        self.flags = tuple(flags)


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
    again."""

    def __init__(self, fn, arrs):
        self._fn = fn
        self._event = None
        self._host = list(arrs)
        if not arrs or arrs[0].device.type != "cuda":
            return
        dev = arrs[0].device
        chunks, self._layout = [], []
        for p in arrs:
            b = p.contiguous().reshape(-1).view(torch.uint8)
            self._layout.append((p.dtype, tuple(p.shape), b.numel()))
            chunks.append(b)
            if b.numel() % 8:  # keep every part 8-byte aligned
                chunks.append(b.new_zeros(8 - b.numel() % 8))
        buf = torch.cat(chunks)
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
        if self._event is not None:
            self._event.synchronize()
            self._event, o, self._host = None, 0, []
            for dtype, shape, nb in self._layout:
                self._host.append(self._buf[o : o + nb].view(dtype).reshape(shape))
                o += -(-nb // 8) * 8
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
    defer_pull: bool = False, check_labels: tuple = (),
):
    """Full dense-grid reconstruction on the positions' device (reference
    ``ops/global_sweep.py:1196-1285``). Returns (vertices (V, 3), triangles
    (T, 3) int32) on the host, as CPU tensors.

    The frame runs on the overflow plan of its (grid, N), by default N / 64
    rounded up to a power of two (at least 4096), and on the MC and pull
    plans of its (grid, dtype) (``_finish_global_dense``); a raster
    overflow past the plan's capacity grows the plan and rasterizes again.
    ``deferred_checks`` (device bools, such as the density and grid plans'
    checks, named by ``check_labels``) come back with the mesh totals; a
    False one raises :class:`SpeculationMiss`. With ``defer_pull`` returns
    a :class:`PendingPull` instead, whose ``resolve()`` validates the plans
    and checks as the reference's does and reports a miss as a redo.
    """
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    n = positions.shape[0]
    okey = (grid.n_points, n)
    ocap = _OVER_PLAN.get(okey)
    if ocap is None:
        ocap = _pow2(n // 64, lo=4096)
    for _ in range(4):
        rasters, overflow, n_over = rasterize_global(positions, values, grid, slots, hsc, ocap)
        if okey not in _OVER_PLAN:
            # no plan yet: this frame reads counts back anyway, so it splats
            # the real rows only (the sums are those of the whole list)
            overflow = tuple(c[: int(n_over)] for c in overflow)
        ls = sweep_global(rasters, overflow, grid, compact_support_radius, hsc)
        del rasters, overflow
        out = _finish_global_dense(
            ls, grid, iso, okey, ocap, n_over, deferred_checks, defer_pull, check_labels
        )
        if out is not None:
            return out if defer_pull else out.resolve()[1:]
        # the level set misses the dropped overflow splats: grow the plan
        SPECULATION_STATS["overflow_retry"] += 1
        ocap = min(_pow2(_LAST_OVERFLOW[0] * 2, lo=4096), _pow2(n))
        _OVER_PLAN[okey] = ocap
    raise RuntimeError(f"raster overflow exceeded capacity {ocap} after retries")


def _finish_global_dense(ls, grid: UniformGrid, iso, okey, overflow_capacity, n_over,
                         deferred_checks=(), defer_pull=False, check_labels=()):
    """Marching cubes and the mesh copy of a dense frame (reference
    ``ops/global_sweep.py:1397-1565``, its packed pull).

    The planning frame of a (grid, dtype) runs MC on lists of exact size
    (their counts read back) and plans the MC capacities from them. A frame
    with capacities writes into buffers of them. With a pull plan too, it
    packs the mesh in the plan's buckets and copies it together with its
    totals, the overflow count, the level set's maximum and the deferred
    checks, in one copy (``PendingPull``); without one it reads those
    scalars first, then copies the exact mesh.

    Returns a :class:`PendingPull`, or None when the frame's raster overflow
    exceeded ``overflow_capacity`` (the caller rasterizes again). With
    ``defer_pull`` on a frame with every plan, the returned pull has not
    been read: its ``resolve()`` runs the checks below, updates the plans
    on a miss exactly as they do, and reports the miss as a redo.
    Otherwise the checks run here: a False deferred check raises
    :class:`SpeculationMiss`, an MC total past its capacity grows the
    capacities and runs MC again (``caps_retry``).
    """
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    iso = kernels.rounded(iso, ls.dtype)
    key = (grid.n_points, str(ls.dtype))
    f64 = lambda x: x.reshape(1).to(torch.float64)
    tail = [f64(n_over), f64(ls.max())] + [f64(c) for c in deferred_checks]
    while True:
        caps = _MC_CAPS.get(key)
        points, words, t = mc_point_words(ls, grid, iso, capacity=None if caps is None else caps[1])
        verts, tris = mc_mesh_from_points(points, words, t, grid, caps)
        if caps is None:
            caps = (_bucket16(verts.shape[0] * 5 // 4), _bucket16(tris.shape[0] * 5 // 4))
            _MC_CAPS[key] = caps
        vcap, tcap = caps
        scalars = torch.cat([_mc_totals(words).to(torch.float64)] + tail)
        plan = _PULL_PLAN.get(key)
        if plan is not None and plan[0] <= vcap and plan[1] <= tcap:
            pull_parts = [scalars, verts[: plan[0]], tris[: plan[1]]]
            if defer_pull:
                return PendingPull(functools.partial(
                    _resolve_deferred, verts=verts, tris=tris, iso=iso, caps=caps,
                    key=key, okey=okey, overflow_capacity=overflow_capacity,
                    check_labels=check_labels,
                ), pull_parts)
            sc, hv, ht = PendingPull(None, pull_parts).host_parts()
        else:
            sc, hv, ht = scalars.cpu(), None, None
        total_v, total_t, total_c, total_over, ls_max, *flags = sc.tolist()
        total_v, total_t, total_c, total_over = (
            int(x) for x in (total_v, total_t, total_c, total_over)
        )
        if not all(flags):
            raise SpeculationMiss([bool(f) for f in flags])
        if total_over > overflow_capacity:
            _LAST_OVERFLOW[0] = total_over
            return None
        if total_v > vcap or total_t > tcap or total_c > tcap:
            SPECULATION_STATS["caps_retry"] += 1
            _MC_CAPS[key] = (_bucket16(total_v * 5 // 4), _bucket16(total_t * 5 // 4))
            _PULL_PLAN.pop(key, None)
            continue
        _PULL_PLAN[key] = (min(vcap, _bucket16(total_v)), min(tcap, _bucket16(total_t)))
        if total_t == 0:
            check_empty_field(0, ls_max, iso)
        _note_overflow_plan(okey, total_over)
        if hv is None or total_v > hv.shape[0] or total_t > ht.shape[0]:
            return PendingPull(lambda v, t: ("ok", v, t), [verts[:total_v], tris[:total_t]])
        return PendingPull(lambda: ("ok", hv[:total_v], ht[:total_t]), [])


def _resolve_deferred(sc, hv, ht, *, verts, tris, iso, caps, key, okey,
                      overflow_capacity, check_labels):
    """The checks of a deferred warm frame on its pulled scalars (reference
    ``_defer_encoded_pull``'s resolver, ``ops/global_sweep.py:1306-1359``):
    a miss updates the plan it concerns and returns ``("redo",)``, or
    ``("redo_grid",)`` for the grid; otherwise ``("ok", vertices,
    triangles)``."""
    from splashsurf_tpu_torch import neighbors
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    total_v, total_t, total_c, total_over, ls_max, *flags = sc.tolist()
    total_v, total_t, total_c, total_over = (
        int(x) for x in (total_v, total_t, total_c, total_over)
    )
    vcap, tcap = caps
    if not all(flags):
        failed = {check_labels[i] for i, ok in enumerate(flags) if not ok}
        if "grid" in failed:
            SPECULATION_STATS["grid_miss"] += 1
            return ("redo_grid",)
        SPECULATION_STATS["density_miss"] += 1
        neighbors.clear_density_plan()
        return ("redo",)
    if total_over > overflow_capacity:
        SPECULATION_STATS["overflow_retry"] += 1
        _OVER_PLAN[okey] = _pow2(total_over * 2, lo=4096)
        return ("redo",)
    if total_v > vcap or total_t > tcap or total_c > tcap:
        SPECULATION_STATS["caps_retry"] += 1
        _MC_CAPS[key] = (_bucket16(total_v * 5 // 4), _bucket16(total_t * 5 // 4))
        _PULL_PLAN.pop(key, None)
        return ("redo",)
    if total_v > hv.shape[0] or total_t > ht.shape[0]:
        # a bucket miss: copy the exact mesh (one more read)
        hv, ht = PendingPull(None, [verts[:total_v], tris[:total_t]]).host_parts()
    _PULL_PLAN[key] = (min(vcap, _bucket16(total_v)), min(tcap, _bucket16(total_t)))
    _note_overflow_plan(okey, total_over)
    if total_t == 0:
        check_empty_field(0, ls_max, iso)
    return ("ok", hv[:total_v], ht[:total_t])
