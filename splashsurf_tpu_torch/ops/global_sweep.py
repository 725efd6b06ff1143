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
once over the merged active points.

Every intermediate has its exact size: eager PyTorch reads counts back where
it needs them, so no capacities, buckets or retries are planned.
"""

from __future__ import annotations

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
                     with_meta: bool = False, slab_ncx: Optional[int] = None,
                     slab_x0: int = 0):
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
        return fracs, int(over.sum()), (rank, ok, *cell)
    rasters = fracs + (kernels.scatter_table(dest, values, total, 0.0, shape),)
    overflow = [px[d][over] for d in range(3)] + [values[over]]
    return rasters, tuple(overflow)


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
    offs = torch.as_tensor(supported_point_offsets(hsc).astype(np.int64), device=dev)
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
        out_flat.index_add_(0, flat[in_grid], w[in_grid])
    return out


def sweep_global(rasters, overflow, grid: UniformGrid, compact_support_radius, hsc: int,
                 slab_npx: Optional[int] = None, slab_x0: int = 0):
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
    return _scatter_splat_points(*overflow, grid, compact_support_radius, hsc, acc, slab_x0)


def mc_point_words(ls: torch.Tensor, grid: UniformGrid, iso, x0: int = 0,
                   own_px: Optional[int] = None):
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
    edge is inactive): computed for every point so that nothing is read
    back here."""
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
    points_c = torch.nonzero(word_flat).squeeze(1)  # ascending flat id
    words_c = word_flat[points_c].long()

    ls_flat = ls.reshape(-1)
    v0 = ls_flat[points_c]
    step = torch.tensor([PY * PZ, PZ, 1], device=dev)[:, None]
    denom = ls_flat[torch.clamp_max(points_c + step, n_pts - 1)] - v0
    t = torch.clamp(
        (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
    )
    return points_c + x0 * PY * PZ, words_c, t


def mc_mesh_from_points(points: torch.Tensor, words: torch.Tensor, t: torch.Tensor,
                        grid: UniformGrid):
    """Marching cubes, part (b): vertices and triangles from the active
    points of the whole grid (``mc_point_words``, or the merge of every
    slab's, in ascending global id).

    Vertices are axis-major (all x-edge vertices in active-point order, then
    y, then z) and triangles follow the active points, then the case-table
    slots. A triangle corner's vertex belongs to a neighbour point, whose
    rank comes from a binary search over ``points``. Returns vertices (V, 3)
    and triangles (T, 3) int32 on the device: the lists of the reference
    package's unencoded output."""
    dev = points.device
    dtype = t.dtype
    _, PY, PZ = grid.n_points
    cs = kernels.rounded(grid.cell_size, dtype)
    total_c = points.shape[0]

    # --- vertex stream: one vertex per active origin edge, axis-major -----
    emask = torch.cat([(words >> b) & 1 for b in (8, 9, 10)]) == 1
    vidx_pos = torch.cumsum(emask, 0) - 1  # vertex id of (axis, rank)
    vslot = torch.nonzero(emask).squeeze(1)
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
    count_t, tab_t = lut_tensors(dev)
    cases_c = words & 0xFF
    counts = count_t[cases_c]
    total_t = int(counts.sum())
    slot_map = torch.repeat_interleave(
        torch.arange(total_c, device=dev), counts, output_size=total_t
    )
    offsets = torch.cumsum(counts, 0) - counts
    slot_in_cell = torch.arange(total_t, device=dev) - offsets[slot_map]
    acase = cases_c[slot_map]
    tpoint = points[slot_map]
    eb = lut.EDGE_BASE_OFFSET.astype(np.int64)
    edge_delta = torch.as_tensor(eb[:, 0] * PY * PZ + eb[:, 1] * PZ + eb[:, 2], device=dev)
    edge_axis = torch.as_tensor(lut.EDGE_AXIS.astype(np.int64), device=dev)
    cols = []
    for corner in range(3):
        local = tab_t[acase, slot_in_cell, corner]
        nrank = torch.searchsorted(points, tpoint + edge_delta[local])
        cols.append(vidx_pos[edge_axis[local] * total_c + nrank])
    triangles = torch.stack(cols, dim=1).to(torch.int32)
    return vertices, triangles


def mc_global_cells(ls: torch.Tensor, grid: UniformGrid, iso) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-list marching cubes over the level set on the whole grid's
    points: ``mc_point_words`` then ``mc_mesh_from_points``."""
    return mc_mesh_from_points(*mc_point_words(ls, grid, iso), grid)


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


def reconstruct_global_dense(
    positions, values, grid: UniformGrid, compact_support_radius: float,
    hsc: int, iso: float, slots: int = 2,
):
    """Full dense-grid reconstruction on the positions' device. Returns
    (vertices (V, 3), triangles (T, 3) int32) as device tensors."""
    rasters, overflow = rasterize_global(positions, values, grid, slots, hsc)
    ls = sweep_global(rasters, overflow, grid, compact_support_radius, hsc)
    del rasters
    return mesh_from_level_set(ls, grid, iso)


def mesh_from_level_set(ls: torch.Tensor, grid: UniformGrid, iso):
    """``mc_global_cells`` plus the empty-mesh guard: (vertices, triangles)
    on the device."""
    verts, tris = mc_global_cells(ls, grid, iso)
    if tris.shape[0] == 0:
        check_empty_field(0, float(ls.max()), float(iso))
    return verts, tris
