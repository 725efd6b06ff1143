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
  3. ``mc_global_cells`` - marching cubes over the active points, building
     vertices and triangles on the device.

Every intermediate has its exact size: eager PyTorch reads counts back where
it needs them, so no capacities, buckets or retries are planned.
"""

from __future__ import annotations

from typing import Tuple

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
                     with_meta: bool = False):
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
    Xp, Yp, Zp = ncx + 2 * pad, ncy + 2 * pad, ncz + 2 * pad
    cs = kernels.rounded(grid.cell_size, dtype)
    mn = [kernels.rounded(grid.min[d], dtype) for d in range(3)]
    px = [positions[:, d] for d in range(3)]
    cell = [_cell_of(px[d], mn[d], cs, nc) for d, nc in enumerate(grid.n_cells)]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for d, nc in enumerate(grid.n_cells):
        valid &= (cell[d] >= 0) & (cell[d] < nc)
    ncells = ncx * ncy * ncz
    cflat = torch.where(valid, (cell[0] * ncy + cell[1]) * ncz + cell[2], ncells)

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
    dest = ((rank * Xp + cell[0] + pad) * Yp + cell[1] + pad) * Zp + cell[2] + pad
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


def _scatter_splat_points(opx, opy, opz, oval, grid: UniformGrid, h, hsc, out_flat):
    """Scatter-add splat of the (few) overflow particles onto the grid
    points. ``index_add_`` runs with atomics on CUDA, so the order of the
    sums at a point, and its last bits, change from run to run."""
    dtype = opx.dtype
    dev = opx.device
    npts = grid.n_points
    strides = (npts[1] * npts[2], npts[2], 1)
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
            p = cell[d][sl, None] + offs[None, :, d]
            delta = kernels.grid_coord(p, grid.min[d], cs, dtype) - pxs[d][sl, None]
            d2 = d2 + delta * delta
            in_grid = in_grid & (p >= 0) & (p < npts[d])
            flat = flat + p * strides[d]
        w = kernels.cubic_kernel(torch.sqrt(d2), h) * oval[sl, None]
        out_flat.index_add_(0, flat[in_grid], w[in_grid])
    return out_flat


def sweep_global(rasters, overflow, grid: UniformGrid, compact_support_radius, hsc: int):
    """Level set phi on the (PX, PY, PZ) grid points: the dense stencil
    sweep over the rasters (kernel K1 on CUDA, its plain version on the
    CPU) plus the scatter splat of the overflow particles."""
    acc = sweep_global_cuda(
        *rasters, grid.cell_size, compact_support_radius, hsc, grid.n_points
    )
    if overflow[0].shape[0] == 0:
        return acc
    return _scatter_splat_points(
        *overflow, grid, compact_support_radius, hsc, acc.reshape(-1)
    ).reshape(acc.shape)


def mc_global_cells(ls: torch.Tensor, grid: UniformGrid, iso) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-list marching cubes over the level set on the grid points.

    Each grid point owns its three origin edges (+x/+y/+z) and, when it is
    not on a far boundary plane, the cell with the same ijk. An 11-bit word
    per point packs the cell's case (bits 0-7, 0 when there is no cell or
    the cell is all inside/outside) and the three edges' activity (bits
    8-10). Active points (word != 0) are compacted in ascending flat order;
    vertices are axis-major (all x-edge vertices in active-point order, then
    y, then z) and triangles follow the active points, then the case-table
    slots. Returns vertices (V, 3) and triangles (T, 3) int32 on the device:
    the lists of the reference package's unencoded output.
    """
    dtype = ls.dtype
    dev = ls.device
    PX, PY, PZ = ls.shape
    n_pts = PX * PY * PZ
    iso = kernels.rounded(iso, dtype)
    cs = kernels.rounded(grid.cell_size, dtype)
    inside = ls >= iso
    insp = torch.nn.functional.pad(inside.to(torch.uint8), (0, 1, 0, 1, 0, 1))

    def win(oi, oj, ok):
        return insp[oi : oi + PX, oj : oj + PY, ok : ok + PZ]

    base = win(0, 0, 0)
    case = torch.zeros((PX, PY, PZ), dtype=torch.int32, device=dev)
    for c8 in range(8):
        case |= win((c8 >> 2) & 1, (c8 >> 1) & 1, c8 & 1).to(torch.int32) << c8
    # the cell bits are dropped on far-boundary points (they own no cell)
    ii = torch.arange(PX, device=dev)[:, None, None]
    jj = torch.arange(PY, device=dev)[None, :, None]
    kk = torch.arange(PZ, device=dev)[None, None, :]
    has_cell = (ii < PX - 1) & (jj < PY - 1) & (kk < PZ - 1)
    word = torch.where(has_cell & (case != 0) & (case != 255), case, 0)
    for a, bit in ((0, 8), (1, 9), (2, 10)):
        nbr = win(int(a == 0), int(a == 1), int(a == 2))
        in_rng = (ii, jj, kk)[a] < (PX, PY, PZ)[a] - 1
        word |= ((base != nbr) & in_rng).to(torch.int32) << bit
    word_flat = word.reshape(-1)
    points_c = torch.nonzero(word_flat).squeeze(1)  # ascending flat id
    words_c = word_flat[points_c].long()
    total_c = points_c.shape[0]

    # --- vertex stream: one vertex per active origin edge, axis-major -----
    emask = torch.cat([(words_c >> b) & 1 for b in (8, 9, 10)]) == 1
    vidx_pos = torch.cumsum(emask, 0) - 1  # vertex id of (axis, rank)
    vslot = torch.nonzero(emask).squeeze(1)
    vaxis = vslot // max(total_c, 1)
    p0 = points_c[vslot - vaxis * total_c]
    step = torch.where(vaxis == 0, PY * PZ, torch.where(vaxis == 1, PZ, 1))
    ls_flat = ls.reshape(-1)
    v0 = ls_flat[p0]
    denom = ls_flat[torch.clamp_max(p0 + step, n_pts - 1)] - v0
    t = torch.clamp(
        (iso - v0) / torch.where(denom == 0, torch.ones_like(denom), denom), 0.0, 1.0
    )
    vijk = (p0 // (PY * PZ), (p0 // PZ) % PY, p0 % PZ)
    verts = []
    for d in range(3):
        pos = kernels.grid_coord(vijk[d], grid.min[d], cs, dtype)
        verts.append(pos + torch.where(vaxis == d, t, 0.0) * cs)
    vertices = torch.stack(verts, dim=1)

    # --- triangle stream --------------------------------------------------
    count_t, tab_t = lut_tensors(dev)
    rank_map = torch.zeros(n_pts, dtype=torch.int32, device=dev)
    rank_map[points_c] = torch.arange(total_c, dtype=torch.int32, device=dev)
    cases_c = words_c & 0xFF
    counts = count_t[cases_c]
    total_t = int(counts.sum())
    slot_map = torch.repeat_interleave(
        torch.arange(total_c, device=dev), counts, output_size=total_t
    )
    offsets = torch.cumsum(counts, 0) - counts
    slot_in_cell = torch.arange(total_t, device=dev) - offsets[slot_map]
    acase = cases_c[slot_map]
    tpoint = points_c[slot_map]
    eb = lut.EDGE_BASE_OFFSET.astype(np.int64)
    edge_delta = torch.as_tensor(eb[:, 0] * PY * PZ + eb[:, 1] * PZ + eb[:, 2], device=dev)
    edge_axis = torch.as_tensor(lut.EDGE_AXIS.astype(np.int64), device=dev)
    cols = []
    for corner in range(3):
        local = tab_t[acase, slot_in_cell, corner]
        nrank = rank_map[tpoint + edge_delta[local]].long()
        cols.append(vidx_pos[edge_axis[local] * total_c + nrank])
    triangles = torch.stack(cols, dim=1).to(torch.int32)
    return vertices, triangles


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
