"""SPH density splat: particles -> level set on the marching cubes grid
(PyTorch port of ``splashsurf_tpu.density``).

The level set is phi(x) = sum_i (m / rho_i) * W(|x - x_i|) at the grid
points (density_map.rs:636-737, dense_subdomains.rs:784-847), in two exact
formulations on the caller's device:

1. ``splat_level_set_scatter``: a particle-centric scatter-add over each
   particle's (2*hsc+2)^3 supported points, the oracle, also used for the
   overflow particles;
2. ``splat_level_set``: particles rasterized into per-cell slots
   (``rasterize_particles``), then a dense stencil sweep over the cell
   offsets within the support.

Both are plain PyTorch, as the reference's are plain JAX. The routes'
level sets run the same function through kernels K1 and K3
(``ops.splat_kernels``) on 2-slot rasters; these keep the reference's
4-slot raster and overflow contract.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents


def supported_point_offsets(hsc: int) -> np.ndarray:
    """Offsets from a particle's cell to all potentially supported points:
    (2*hsc+2)^3 point offsets in [-hsc, hsc+1]^3 (density_map.rs:649-663)."""
    rng = np.arange(-hsc, hsc + 2, dtype=np.int32)
    oi, oj, ok = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack([oi, oj, ok], axis=-1).reshape(-1, 3)


def gather_cell_offsets(hsc: int) -> np.ndarray:
    """Offsets from a grid point's base cell to the cells that can hold
    contributing particles, pruned to the support sphere: keep an offset o
    when the per-axis distance from the point to the cell interval [o, o+1]
    (in cube units) is below hsc (+ rounding slack)."""
    rng = np.arange(-(hsc + 1), hsc + 1, dtype=np.int32)
    oi, oj, ok = np.meshgrid(rng, rng, rng, indexing="ij")
    offs = np.stack([oi, oj, ok], axis=-1).reshape(-1, 3)
    d = np.where(offs > 0, offs, np.where(offs + 1 < 0, -(offs + 1), 0)).astype(
        np.float64
    )
    keep = (d**2).sum(axis=1) <= (hsc * (1.0 + 1e-3)) ** 2
    return offs[keep]


class RasterizedParticles(NamedTuple):
    """Particles rasterized into dense per-cell slots (tensors on the
    positions' device)."""

    pos: torch.Tensor  # (ncx, ncy, ncz, slots, 3), 0 in empty slots
    val: torch.Tensor  # (ncx, ncy, ncz, slots), 0 in empty slots
    overflow_pos: torch.Tensor  # (overflow_capacity, 3), far sentinel past the count
    overflow_val: torch.Tensor  # (overflow_capacity,)
    num_overflow: torch.Tensor  # () int64, the true overflow count


# (particles x offsets) entries of one chunk of the scatter splat: each entry
# holds a few int64 and float temporaries, so one chunk's working set stays
# near 1 GB.
SCATTER_CHUNK_ENTRIES = 1 << 24


def rasterize_particles(
    positions,
    values,
    grid: UniformGrid,
    slots: int,
    overflow_capacity: int = 256,
    ranks=None,
    device=None,
) -> RasterizedParticles:
    """Scatter particles into (cells, slots) dense tables.

    ``values`` are the per-particle splat weights v_i = m / rho_i. Slot ranks
    follow the stable bin-sorted order (ascending particle index within a
    cell); a particle of rank >= ``slots`` goes to the overflow list, in
    that order, and those past ``overflow_capacity`` are dropped while
    ``num_overflow`` keeps the true count. ``ranks``: precomputed slot ranks
    (the particles are then taken in their given order). Cells are clamped
    into the grid. A tensor runs on its own device, anything else on
    ``device`` (``placement.on_device``)."""
    positions = on_device(positions, device=device)
    values = on_device(values, device=positions.device)
    dev = positions.device
    ncx, ncy, ncz = grid.n_cells
    hi = torch.tensor(grid.n_cells, device=dev) - 1
    cell = torch.minimum(grid.enclosing_cell(positions).clamp_min(0), hi)
    flat = grid.flatten_cell_index(cell)
    if ranks is None:
        flat_s, order = torch.sort(flat, stable=True)
        start = torch.searchsorted(flat_s, flat_s, side="left")
        rank = torch.arange(flat_s.shape[0], device=dev) - start
        pos_s, val_s = positions[order], values[order]
    else:
        rank = on_device(ranks, device=dev).to(torch.int64)
        flat_s, pos_s, val_s = flat, positions, values

    total = ncx * ncy * ncz * slots
    ok = rank < slots
    dest = torch.where(ok, flat_s * slots + rank, total)
    rpos = torch.stack(
        [kernels.scatter_table(dest, pos_s[:, d], total, 0.0, (total,)) for d in range(3)],
        dim=1,
    ).reshape(ncx, ncy, ncz, slots, 3)
    rval = kernels.scatter_table(dest, val_s, total, 0.0, (ncx, ncy, ncz, slots))

    over = ~ok
    odest = torch.where(over, torch.cumsum(over, 0) - 1, overflow_capacity)
    odest = odest.clamp_max(overflow_capacity)  # past the capacity: dropped
    far = kernels.far_fill(positions.dtype)
    opos = torch.stack(
        [kernels.scatter_table(odest, pos_s[:, d], overflow_capacity, far, (overflow_capacity,))
         for d in range(3)],
        dim=1,
    )
    oval = kernels.scatter_table(odest, val_s, overflow_capacity, 0.0, (overflow_capacity,))
    return RasterizedParticles(
        pos=rpos, val=rval, overflow_pos=opos, overflow_val=oval, num_overflow=over.sum()
    )


def splat_level_set_scatter(
    positions, values, grid: UniformGrid, compact_support_radius, hsc: int, device=None
) -> torch.Tensor:
    """Particle-centric scatter-add splat over each particle's
    (2*hsc+2)^3 supported points (the oracle path): the (npx, npy, npz)
    level set on the positions' device. Points outside the grid are dropped;
    particles are assumed well inside it. Chunked over particles and offset
    blocks (``SCATTER_CHUNK_ENTRIES``). ``index_add_`` runs with atomics on
    CUDA, so the last bits of a point's sum change from run to run."""
    positions = on_device(positions, device=device)
    values = on_device(values, device=positions.device)
    dtype, dev = positions.dtype, positions.device
    npts = grid.n_points
    strides = (npts[1] * npts[2], npts[2], 1)
    total = npts[0] * npts[1] * npts[2]
    cs = kernels.rounded(grid.cell_size, dtype)
    pxs = [positions[:, d] for d in range(3)]
    cell = grid.enclosing_cell(positions).unbind(1)
    offs = torch.as_tensor(supported_point_offsets(hsc).astype(np.int64), device=dev)
    oblock = min(offs.shape[0], SCATTER_CHUNK_ENTRIES)
    rows = max(1, SCATTER_CHUNK_ENTRIES // oblock)
    out = torch.zeros(total + 1, dtype=dtype, device=dev)  # index ``total``: dropped
    for ob in range(0, offs.shape[0], oblock):
        o = offs[ob : ob + oblock]
        for b in range(0, positions.shape[0], rows):
            sl = slice(b, b + rows)
            d2 = 0.0
            flat = 0
            in_grid = True
            for d in range(3):
                p = cell[d][sl, None] + o[None, :, d]
                delta = kernels.grid_coord(p, grid.min[d], cs, dtype) - pxs[d][sl, None]
                if dtype == torch.float64:
                    # far-sentinel rows contribute an exact 0 (density.py:200-205 of
                    # the reference)
                    delta = delta.clamp(-1e15, 1e15)
                d2 = d2 + delta * delta
                in_grid = in_grid & (p >= 0) & (p < npts[d])
                flat = flat + p * strides[d]
            w = kernels.cubic_kernel(torch.sqrt(d2), compact_support_radius) * values[sl, None]
            out.index_add_(0, torch.where(in_grid, flat, total).reshape(-1), w.reshape(-1))
    return out[:total].reshape(npts)


def _window(table: torch.Tensor, starts, sizes) -> torch.Tensor:
    """``table[..., s0:s0+n0, s1:s1+n1, s2:s2+n2]`` over its last three axes,
    each start clamped so that the window fits (as ``lax.dynamic_slice``
    clamps)."""
    lead = table.dim() - 3
    idx = [slice(None)] * lead
    for a, (s, n) in enumerate(zip(starts, sizes)):
        s = min(max(int(s), 0), table.shape[lead + a] - n)
        idx.append(slice(s, s + n))
    return table[tuple(idx)]


def _splat_raster_sweep(
    raster: RasterizedParticles,
    grid: UniformGrid,
    compact_support_radius,
    hsc: int,
    point_offset=(0, 0, 0),
) -> torch.Tensor:
    """Dense stencil sweep over rasterized particles: the level set on the
    grid's (ncx+1, ncy+1, ncz+1) points shifted by ``point_offset``, summed
    over ``gather_cell_offsets(hsc)`` (slots summed per offset, offsets in
    table order). Point coordinates come from global indices, so that
    subdomains agree bit for bit (dense_subdomains.rs:817-826)."""
    dtype, dev = raster.pos.dtype, raster.pos.device
    ncx, ncy, ncz = grid.n_cells
    sizes = (ncx + 1, ncy + 1, ncz + 1)
    pad = hsc + 1
    # component planes (3, slots, X, Y, Z) and values (slots, X, Y, Z), padded
    rpos = torch.nn.functional.pad(raster.pos.permute(4, 3, 0, 1, 2), (pad,) * 6)
    rval = torch.nn.functional.pad(raster.val.permute(3, 0, 1, 2), (pad,) * 6)
    cs = kernels.rounded(grid.cell_size, dtype)
    coord = []
    for d in range(3):
        idx = torch.arange(sizes[d], device=dev) + int(point_offset[d])
        shape = [1, 1, 1]
        shape[d] = sizes[d]
        coord.append(kernels.grid_coord(idx, grid.min[d], cs, dtype).reshape(shape))
    acc = torch.zeros(sizes, dtype=dtype, device=dev)
    for o in (gather_cell_offsets(hsc) + pad).tolist():
        starts = [o[d] + int(point_offset[d]) for d in range(3)]
        p = _window(rpos, starts, sizes)
        d2 = (p[0] - coord[0]).square_()
        d2 += (p[1] - coord[1]).square_()
        d2 += (p[2] - coord[2]).square_()
        w = kernels.cubic_kernel(d2.sqrt_(), compact_support_radius)
        w *= _window(rval, starts, sizes)
        acc += w.sum(dim=0)
    return acc


def splat_level_set(
    positions,
    values,
    grid: UniformGrid,
    compact_support_radius,
    hsc: int,
    slots: int = 4,
    overflow_capacity: int = 256,
    device=None,
):
    """Raster splat: returns (level set (npx, npy, npz), num_overflow), the
    overflow particles added through the scatter path. Callers check
    num_overflow <= overflow_capacity (and re-run with a larger capacity
    otherwise, as ``splat_level_set_auto`` does); past the capacity the
    dropped particles are missing from the level set."""
    raster = rasterize_particles(positions, values, grid, slots, overflow_capacity, device=device)
    levelset = _splat_raster_sweep(raster, grid, compact_support_radius, hsc)
    # empty overflow rows: far positions (out of the grid, dropped) and zero values
    opos = torch.where(torch.isfinite(raster.overflow_pos), raster.overflow_pos, -1e30)
    over = splat_level_set_scatter(opos, raster.overflow_val, grid, compact_support_radius, hsc)
    return levelset + over, raster.num_overflow


def splat_level_set_auto(
    positions, values, grid: UniformGrid, compact_support_radius: float, device=None
) -> torch.Tensor:
    """Host wrapper: picks hsc, 4 slots and an overflow capacity of 256, and
    retries with max(2 * capacity, 2 * num_overflow) until the overflow
    fits."""
    hsc = kernel_extents(compact_support_radius, grid.cell_size).half_supported_cells
    slots = 4
    overflow_capacity = 256
    while True:
        levelset, n_over = splat_level_set(
            positions, values, grid, compact_support_radius, hsc,
            slots=slots, overflow_capacity=overflow_capacity, device=device,
        )
        n_over = int(n_over)
        if n_over <= overflow_capacity:
            return levelset
        overflow_capacity = max(2 * overflow_capacity, 2 * n_over)
