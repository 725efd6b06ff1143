"""Sharded SPH densities over a device mesh (PyTorch port of
``splashsurf_tpu.parallel.density``): an x-slab decomposition of the bin
lattice.

Shard d holds a block of particle rows. Each particle goes to the shard
that owns its bin's x-slab (``slab_w = ceil(LX / D)`` planes), and a
particle on a slab's first or last plane also goes, as halo, to the
neighbouring slab, whose 27-bin stencil reads that plane. Each shard fills
the (8, slab_w + 4, LY + 2, LZ + 2) rasters of its slab and its halo planes
and runs the bin sweep on them: kernel K2 (``density_sweep_cuda``) on its
device, the plain version on the CPU. The densities of the owned particles
go home with a second exchange. The formulation is the single-device
wrapper's, chosen by the same gate (``neighbors.density_gate``):

  * geoslot: the slot is the particle's half-bin octant, a pure function of
    its position and the (phase-aligned) lattice: no order to reproduce;
  * raster: particles sorted by slab bin take their within-bin rank as
    slot, 8 slots per bin, and ranks >= 8 go through the exact overflow
    correction on the slab (``neighbors._overflow_correction``, which takes
    each query's stencil from its sorted bin id);
  * binned (sparse lattices), lattices past ``GATE_LATTICE_MAX`` and a mesh
    of one device: the single-device wrapper on the whole set, replicated.

The result equals the single-device densities bit for bit:

  * slot ranks follow the global (bin, particle index) order: the received
    rows come in device order, each source's rows ascending, so rows ascend
    in global index, and one stable sort by slab bin ties as the global
    sort does;
  * the fractions come from global quantities, with the single-device
    expressions (the lattice's bin corner, ``kernels.grid_coord``);
  * the sweep of a query bin reads the same neighbour slots in the same
    order on the slab as on the whole lattice.

Only the overflow correction's scatter-add order differs (per slab rather
than over the whole lattice), so scenes with slot overflow agree to
tolerance, all others bit for bit, as in the reference.

Rows past ``n_valid`` are count-padding dummies: they shape nothing (the
lattice, the statistics, the phase) and come back 0.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch import neighbors as N
from splashsurf_tpu_torch.neighbors import GATE_LATTICE_MAX, BinGrid, CellList
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.parallel.mesh import (
    DeviceMesh,
    all_to_all,
    blocks,
    make_mesh,
    psum,
)


def _shard_inputs(positions: torch.Tensor, mesh: DeviceMesh, nv: int):
    """Each shard's block of rows on its device (read-only; a view where
    the device is the positions' own) and its validity mask."""
    parts, valid = [], []
    for (lo, hi), dev in zip(blocks(positions.shape[0], mesh.size), mesh.devices):
        parts.append(positions[lo:hi].to(dev))
        valid.append(torch.arange(lo, hi, device=dev) < nv)
    return parts, valid


def _aabb(parts, valid):
    """Host (min, max) of the valid rows, as ``torch.aminmax`` of the whole
    set gives them (a min and a max are exact in any order), in one pull."""
    home = parts[0].device
    rows = [(p, v[:, None]) for p, v in zip(parts, valid) if p.shape[0]]
    lo = torch.stack([torch.where(v, p, torch.inf).amin(0).to(home) for p, v in rows]).amin(0)
    hi = torch.stack([torch.where(v, p, -torch.inf).amax(0).to(home) for p, v in rows]).amax(0)
    lo, hi = torch.stack([lo, hi]).cpu().numpy()
    return lo, hi


def _stats_fn(parts, valid, grid: BinGrid, mesh: DeviceMesh):
    """(max occupancy, occupied bins, particles of bin rank >= 8) of the
    valid rows: each shard's per-bin counts, summed across shards."""
    tables = [
        torch.bincount(grid.flatten(grid.bin_ijk(p))[v], minlength=grid.lattice)
        for p, v in zip(parts, valid)
    ]
    tbl = psum(tables, mesh)[0]
    stats = torch.stack([tbl.max(), (tbl > 0).sum(), (tbl - 8).clamp_min(0).sum()])
    return tuple(int(x) for x in stats.tolist())


def _phase_fn(parts, valid, period: float, mesh: DeviceMesh) -> np.ndarray:
    """Per-axis circular mean of (x mod period) over the valid rows
    (``neighbors._octant_phase``): each shard's cosine and sine sums, summed
    across shards. The sums' order differs from the single-device pass; the
    lattice built from the phases quantizes them, so both give one lattice."""
    sums = []
    for p, v in zip(parts, valid):
        s = kernels.rounded(period, p.dtype)
        x = p[v]
        frac = x - s * torch.floor(x / s)
        ang = frac * (2.0 * math.pi) / s
        sums.append(torch.stack([torch.sin(ang).sum(0), torch.cos(ang).sum(0)]))
    tot = psum(sums, mesh)[0]
    s = kernels.rounded(period, parts[0].dtype)
    return (torch.atan2(tot[0], tot[1]) / (2.0 * math.pi) * s).cpu().numpy()


def _route(p, valid, grid: BinGrid, slab_w: int, D: int):
    """Where one shard's rows go: each valid row to the shard owning its
    bin's x-slab, and a row on a slab's first (last) x-plane also, as halo,
    to the slab before (after) it, whose 27-bin stencil reads that plane.
    Returns (rows sent, whether the receiver owns each, rows per
    destination): destination-major, rows ascending within each."""
    bx = grid.bin_ijk(p)[:, 0]
    sid = torch.clamp(bx // slab_w, max=D - 1)
    plane = bx % slab_w
    dst = torch.stack([
        sid, torch.where(plane == 0, sid - 1, -1), torch.where(plane == slab_w - 1, sid + 1, -1)
    ])
    kind, idx = torch.nonzero(valid & (dst >= 0) & (dst < D), as_tuple=True)
    d = dst[kind, idx]
    order = torch.argsort(d * p.shape[0] + idx)
    return idx[order], (kind == 0)[order], torch.bincount(d, minlength=D).tolist()


def _sweep_slabs(parts, valid, grid: BinGrid, mesh: DeviceMesh, home: torch.device, slab_fn):
    """Route, sweep each slab, route home. ``slab_fn(rows, x_lo, nx)`` gets
    a shard's received positions, all in the lattice's x-planes [x_lo, x_lo
    + nx), and returns (per-row densities, a device ok flag or None).
    Returns the (N,) densities of the owned rows (0 elsewhere) on ``home``,
    and whether every flag held. Records the lattice's dims, the slab width
    and the rows each shard received in ``LAST_GATE["sharded"]``."""
    D = mesh.size
    slab_w = -(-grid.dims[0] // D)
    routes = [_route(p, v, grid, slab_w, D) for p, v in zip(parts, valid)]
    received = all_to_all([p[idx].split(n) for p, (idx, _, n) in zip(parts, routes)], mesh)
    N.LAST_GATE["sharded"].update(
        dims=grid.dims, slab_w=slab_w, rows=[int(r.shape[0]) for r in received])

    back, oks = [], []
    for dst, rows in enumerate(received):
        if rows.shape[0]:
            rho, ok = slab_fn(rows, dst * slab_w - 1, slab_w + 2)
            if ok is not None:
                oks.append(ok)
        else:
            rho = rows.new_zeros(0)
        back.append(rho.split([n[dst] for _, _, n in routes]))  # source-major, as received
    homed = all_to_all(back, mesh)  # shard src: its sent rows' densities, destination-major

    out = []
    for (p, dev), (idx, own, _), rho_sent in zip(zip(parts, mesh.devices), routes, homed):
        rho = torch.zeros(p.shape[0], dtype=p.dtype, device=dev)
        rho[idx[own]] = rho_sent[own]  # the owned rows; halo copies are dropped
        out.append(rho.to(home))
    ok = all(bool(o) for o in oks)
    return torch.cat(out), ok


def _replicated(positions, h, mass, nv: int):
    """The single-device wrapper on the valid rows; dummies come back 0."""
    rho = N.compute_particle_densities(positions[:nv], h, mass)
    n = positions.shape[0]
    return torch.cat([rho, rho.new_zeros(n - nv)]) if nv < n else rho


def compute_particle_densities_sharded(
    positions,
    compact_support_radius: float,
    particle_rest_mass: float,
    mesh: Optional[DeviceMesh] = None,
    n_valid: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Per-particle SPH densities computed over ``mesh`` (by default every
    device of the positions' type in the process's list), returned as one
    (N,) tensor on the positions' device. Equal to
    ``neighbors.compute_particle_densities`` bit for bit but where the
    overflow correction runs (module docstring). ``neighbors.LAST_GATE
    ["sharded"]`` records the decision, its "kind" "geoslot", "raster" or
    "replicated" (the single-device wrapper ran). An array goes to
    ``device`` (``placement.on_device``)."""
    positions = on_device(positions, device=device)
    h, mass = compact_support_radius, particle_rest_mass
    if mesh is None:
        mesh = make_mesh(device=positions.device)
    if any(d.type != positions.device.type for d in mesh.devices):
        raise ValueError(f"positions on {positions.device}, mesh on {mesh.devices}")
    n = positions.shape[0]
    nv = n if n_valid is None else min(int(n_valid), n)
    if mesh.size <= 1:
        N.LAST_GATE["sharded"] = dict(kind="replicated", reason="one device")
        return _replicated(positions, h, mass, nv)

    parts, valid = _shard_inputs(positions, mesh, nv)
    mn, mx = _aabb(parts, valid)
    grid = BinGrid.for_domain(mn, mx, h)
    if grid.lattice > GATE_LATTICE_MAX:
        N.LAST_GATE["sharded"] = dict(kind="replicated", reason="lattice past the gate")
        return _replicated(positions, h, mass, nv)
    max_occ, n_bins, over8 = _stats_fn(parts, valid, grid, mesh)
    if N.density_phase_retry(nv, over8):
        grid2 = N.phase_shifted_bingrid(grid, h)
        stats2 = _stats_fn(parts, valid, grid2, mesh)
        if stats2[2] < over8:
            grid = grid2
            max_occ, n_bins, over8 = stats2
    gate = N.density_gate(nv, grid.lattice, n_bins, max_occ, over8, which="sharded")

    home = positions.device
    if gate["try_geoslot"]:
        phases = _phase_fn(parts, valid, h / 2.0, mesh)
        agrid = N._phase_aligned_bingrid(mn, mx, h, phases)
        if agrid.lattice <= GATE_LATTICE_MAX:
            rho, ok = _sweep_slabs(
                parts, valid, agrid, mesh, home,
                lambda rows, x_lo, nx: N.compute_particle_densities_geoslot(
                    rows, agrid, h, mass, x_lo=x_lo, nx=nx),
            )
            N._note_geoslot_outcome(ok)
            if ok:
                N.note_formulation("sharded", "geoslot")
                return rho
        # octant collisions: the sorted formulations below
    if not gate["use_raster"]:
        N.note_formulation("sharded", "replicated")
        return _replicated(positions, h, mass, nv)

    def raster(rows, x_lo, nx):
        slab = BinGrid(min=grid.min, bin_size=grid.bin_size, dims=(nx,) + grid.dims[1:])
        ijk = grid.bin_ijk(rows)
        ijk[:, 0] -= x_lo
        bins = slab.flatten(ijk)
        sorted_bins, order = torch.sort(bins, stable=True)
        cl = CellList(order, sorted_bins, tuple(rows[:, d][order] for d in range(3)), bins)
        rho = N.compute_particle_densities_raster(
            rows, slab, cl, h, mass, slots=8, overflow_capacity=gate["ocap"],
            candidate_capacity=gate["ccap"], x0=x_lo,
        )
        return rho, None

    rho, _ = _sweep_slabs(parts, valid, grid, mesh, home, raster)
    N.note_formulation("sharded", "raster")
    return rho
