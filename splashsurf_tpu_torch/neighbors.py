"""Per-particle SPH densities and neighbour lists on a bin lattice (PyTorch
port of ``splashsurf_tpu.neighbors``).

Particles are binned on a lattice whose bin size is the compact support h,
so every neighbour of a particle lies in the 27 bins around its own. Two
formulations carry dense fluids, in the reference's order:

1. geoslot: on a lattice phase-aligned to the particles, each particle owns
   one of its bin's 8 half-bin octants, so its raster slot is a pure
   per-particle expression and no sort is needed. Octant collisions are
   detected and send the scene to the next formulation.
2. raster: particles sorted by bin take their within-bin rank as slot;
   ranks >= 8 go through an exact overflow correction.

Both fill (8, LX+2, LY+2, LZ+2) bin-fraction rasters and run the 27-offset
bin sweep (kernel K2, ``ops.splat_kernels.density_sweep_cuda``). Sparse
lattices, which the gate keeps off the dense rasters, take the third:

3. binned: each particle among the first K of its bin's run in the sorted
   cell list sums over the first K particles of the 27 bins around its own
   (kernel K5, ``ops.splat_kernels.binned_sweep_cuda``; the reference has
   no TPU kernel here, its plain version fills (u_cap, K) position tables
   and sweeps (K, K) pair blocks). With K = 8 and a few fuller bins, their
   rank >= 8 particles go through the same exact overflow correction as
   the raster formulation.

The neighbour lists (``neighborhood_search_spatial_hashing_parallel``) use
the same sorted cell list: each query gathers the 27 bins around its own,
in chunks of queries that bound the candidate slots, keeps the candidates
within the search radius, and the lists come to the host in CSR form.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels, plans
from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.ops.splat_kernels import binned_sweep_cuda, density_sweep_cuda
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.profiling import profile, to_host

# Largest materializable bin lattice for the raster/geoslot formulations.
GATE_LATTICE_MAX = 8_000_000


def _bucket_lattice_dim(n: int) -> int:
    """Round a bin-lattice dimension up to its bucket (32 steps per octave;
    ``neighbors.py:28-46`` of the reference). Kept so that the port builds
    the same lattice as the reference package, whose density gate reads the
    bucketed size; padded bins are empty. ``SPLASHSURF_TPU_LATTICE_BUCKET=0``,
    read at each call, keeps ``n``."""
    if os.environ.get("SPLASHSURF_TPU_LATTICE_BUCKET", "1") == "0" or n <= 4:
        return n
    step = max(2, 1 << max(n.bit_length() - 6, 1))
    return -(-n // step) * step


@dataclasses.dataclass(frozen=True)
class BinGrid:
    """Uniform binning lattice (host values)."""

    min: Tuple[float, float, float]
    bin_size: float
    dims: Tuple[int, int, int]

    @staticmethod
    def for_domain(aabb_min, aabb_max, bin_size: float) -> "BinGrid":
        mn = np.asarray(aabb_min, dtype=np.float64) - bin_size
        mx = np.asarray(aabb_max, dtype=np.float64) + bin_size
        dims = np.maximum(np.ceil((mx - mn) / bin_size).astype(np.int64), 1)
        dims = [_bucket_lattice_dim(int(d)) for d in dims]
        total = int(dims[0]) * int(dims[1]) * int(dims[2])
        if total >= 2**31:
            raise ValueError(f"bin lattice too large: {tuple(dims)}")
        return BinGrid(
            min=tuple(mn.tolist()),
            bin_size=float(bin_size),
            dims=tuple(int(d) for d in dims),
        )

    @property
    def lattice(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def bin_ijk(self, positions, device=None) -> torch.Tensor:
        """(M, 3) int64 bin indices, clipped into the lattice."""
        positions = on_device(positions, device=device)
        dtype = positions.dtype
        bs = kernels.rounded(self.bin_size, dtype)
        cols = []
        for d in range(3):
            mn = kernels.rounded(self.min[d], dtype)
            raw = torch.floor((positions[:, d] - mn) / bs)
            cols.append(raw.clamp(0, self.dims[d] - 1).to(torch.int64))
        return torch.stack(cols, dim=1)

    def flatten(self, ijk: torch.Tensor) -> torch.Tensor:
        _, dy, dz = self.dims
        return ijk[..., 0] * (dy * dz) + ijk[..., 1] * dz + ijk[..., 2]


class CellList(NamedTuple):
    """Particles sorted by flat bin id (stable, so ties keep index order)."""

    order: torch.Tensor  # (N,) int64: original index of each sorted slot
    sorted_bins: torch.Tensor  # (N,) int64
    sorted_positions: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    bin_of_particle: torch.Tensor  # (N,) int64: flat bin id per original index


_STENCIL = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int64,
)


@functools.cache
def stencil_on(device: torch.device) -> torch.Tensor:
    """``_STENCIL`` on ``device``, copied there once."""
    return torch.as_tensor(_STENCIL, device=device)


def build_cell_list(positions, grid: BinGrid, device=None) -> CellList:
    """Sort particles by flat bin id with a stable sort."""
    positions = on_device(positions, device=device)
    bins = grid.flatten(grid.bin_ijk(positions))
    sorted_bins, order = torch.sort(bins, stable=True)
    return CellList(
        order=order,
        sorted_bins=sorted_bins,
        sorted_positions=tuple(positions[:, d][order] for d in range(3)),
        bin_of_particle=bins,
    )


def _runs(sorted_bins: torch.Tensor):
    """(is_start, run, first) of the bin-sorted slots: whether each starts
    its bin's run, the run's rank among the occupied bins, and the sorted
    index of the run's first slot; no read-back."""
    n = sorted_bins.shape[0]
    dev = sorted_bins.device
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_bins[1:] != sorted_bins[:-1]
    run = torch.cumsum(is_start, 0) - 1
    first = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(is_start, run, n), torch.arange(n, device=dev))
    return is_start, run, first[run]


def _bin_stats_device(sorted_bins: torch.Tensor) -> torch.Tensor:
    """(max occupancy, occupied bins, particles with bin rank >= 8) as one
    int64 device tensor (``_bin_stats_device`` of the reference,
    ``neighbors.py:154-168``)."""
    _, seg, _ = _runs(sorted_bins)
    counts = torch.zeros_like(seg).scatter_add_(0, seg, torch.ones_like(seg))
    return torch.stack(
        [counts.max(), seg[-1] + 1, torch.clamp_min(counts - 8, 0).sum()]
    )


def bin_stats_ex(cell_list: CellList) -> Tuple[int, int, int]:
    """(max occupancy, occupied bins, particles with bin rank >= 8), read
    back to the host in one transfer."""
    mx, u, o8 = to_host(_bin_stats_device(cell_list.sorted_bins)).tolist()
    return int(mx), int(u), int(o8)


def bin_stats(cell_list: CellList) -> Tuple[int, int]:
    """(max occupancy, occupied bins)."""
    return bin_stats_ex(cell_list)[:2]


def _segment_tables(sorted_bins: torch.Tensor, lattice: int):
    """Dense per-bin (first sorted index, count) tables over the lattice
    (no read-back)."""
    n = sorted_bins.shape[0]
    dev = sorted_bins.device
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_bins[1:] != sorted_bins[:-1]
    starts = torch.zeros(lattice + 1, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(is_start, sorted_bins, lattice), torch.arange(n, device=dev))
    counts = torch.zeros(lattice, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, sorted_bins, torch.ones_like(sorted_bins))
    return starts[:lattice], counts


def gather_candidates(query_positions, grid: BinGrid, cell_list: CellList, capacity: int,
                      tables, device=None):
    """Candidate particle indices from the 27-bin stencil of each query.

    Returns (idx (M, 27*capacity) into the original order, mask (M,
    27*capacity)), stencil offset major and bin-sorted order minor."""
    query_positions, *tables, _ = on_device(
        query_positions, *tables, cell_list.order, device=device
    )
    return stencil_candidates(grid.bin_ijk(query_positions), grid, cell_list, capacity, tables)


def stencil_candidates(q_ijk, grid: BinGrid, cell_list: CellList, capacity: int, tables):
    """``gather_candidates`` for queries given by their (M, 3) bin indices."""
    starts_table, counts_table = tables
    dev = q_ijk.device
    nb = q_ijk[:, None, :] + stencil_on(dev)[None]
    valid = torch.ones(nb.shape[:2], dtype=torch.bool, device=dev)
    cols = []
    for d, dim in enumerate(grid.dims):
        valid &= (nb[..., d] >= 0) & (nb[..., d] < dim)
        cols.append(nb[..., d].clamp(0, dim - 1))
    nb_flat = grid.flatten(torch.stack(cols, dim=-1))
    starts = starts_table[nb_flat]
    counts = torch.where(valid, counts_table[nb_flat], 0)
    slot = torch.arange(capacity, device=dev)
    n = cell_list.order.shape[0]
    gather_pos = torch.clamp(starts[:, :, None] + slot, 0, max(n - 1, 0))
    mask = slot < counts[:, :, None]
    idx = cell_list.order[gather_pos]
    return idx.flatten(1), mask.flatten(1)


def _overflow_correction(positions, grid, cell_list, K, capacity, h, rho, overflow_capacity):
    """Exact correction for particles of within-bin rank >= K, which the
    dense tables leave out: their own density is summed over full candidate
    gathers (self term included), and their contribution is added into the
    table particles. The queries' stencils come from their sorted bin ids,
    never from their positions, so the cell list may be that of one x-slab
    of a larger lattice (``grid`` then has the slab's dims).

    The lists of overflow bins and of overflow particles have the fixed
    size ``overflow_capacity`` (``ocap`` of the gate or the density plan)
    and nothing is read back: the reference's two-level compaction
    (``neighbors.py:589-684``); entries past the capacity are left out, and
    the plan check then misses the frame.

    The index_add_ sums run with atomics on CUDA, so their order, and the
    last bits of the corrected densities, change from run to run."""
    dtype = positions.dtype
    dev = positions.device
    lattice = grid.lattice
    tables = _segment_tables(cell_list.sorted_bins, lattice)
    starts_table, counts_table = tables
    obin = kernels.compact_indices(counts_table > K, overflow_capacity)  # ascending bin id
    ob_ok = obin < lattice
    obin = torch.where(ob_ok, obin, 0)
    base = starts_table[obin]
    cnt = torch.where(ob_ok, counts_table[obin], 0)
    rr = torch.arange(K, capacity, device=dev)
    sid = (base[:, None] + rr[None, :]).reshape(-1)
    take = kernels.compact_indices((rr[None, :] < cnt[:, None]).reshape(-1), overflow_capacity)
    ovalid = take < sid.numel()
    osid = torch.where(ovalid, sid[take.clamp_max(sid.numel() - 1)], 0)
    opos = [cell_list.sorted_positions[d][osid] for d in range(3)]
    oidx = cell_list.order[osid]

    ob = cell_list.sorted_bins[osid]
    _, dy, dz = grid.dims
    q_ijk = torch.stack([ob // (dy * dz), (ob // dz) % dy, ob % dz], dim=1)
    idx, cmask = stencil_candidates(q_ijk, grid, cell_list, capacity, tables)
    cmask = cmask & ovalid[:, None]
    d2o = torch.zeros(idx.shape, dtype=dtype, device=dev)
    for d in range(3):
        diff = positions[:, d][idx] - opos[d][:, None]
        d2o = d2o + diff * diff
    wo = torch.where(cmask, kernels.cubic_kernel(torch.sqrt(d2o), h), 0.0)
    rho_over = torch.sum(wo, dim=1)
    # a candidate's within-bin rank is its stencil slot index: ranks < K are
    # table particles (overflow-overflow pairs are in both own sums already)
    slot_within = torch.arange(capacity, device=dev).repeat(27)[None, :]
    to_table = cmask & (slot_within < K)
    rho = rho.index_add(0, idx.reshape(-1), torch.where(to_table, wo, 0.0).reshape(-1))
    return rho.index_add(0, oidx, torch.where(ovalid, rho_over, 0.0))


def _sweep_readback(rasters, slot, bx, by, bz, ok, LX, bin_size, h):
    """Bin sweep (kernel K2) over ``LX`` x-planes and per-particle read-back
    of its sums."""
    Zp = rasters[0].shape[3]
    acc = density_sweep_cuda(*rasters, LX, bin_size, h)
    width = acc.shape[2]
    src = torch.where(ok, (slot * LX + bx) * width + by * Zp + bz, 0)
    return torch.where(ok, acc.reshape(-1)[src], 0.0)


def compute_particle_densities_raster(
    positions, grid: BinGrid, cell_list: CellList, compact_support_radius,
    particle_rest_mass, slots: int = 8, overflow_capacity: int = 0,
    candidate_capacity: int = 0, x0: int = 0, device=None,
):
    """SPH densities via the dense bin-raster sweep, slots from the
    within-bin rank of the bin-sorted order; with a nonzero
    ``overflow_capacity`` (the size of its lists, see
    :func:`_overflow_correction`) the rank >= ``slots`` particles go
    through the exact overflow correction. Nothing is read back.

    ``grid`` may be an x-slab of a larger lattice: its bin x = 0 is the
    lattice's bin ``x0``, and the bin corners, hence the fractions, are the
    lattice's (the sharded densities, ``parallel.density``)."""
    positions, _ = on_device(positions, cell_list.order, device=device)
    dtype = positions.dtype
    dev = positions.device
    n = positions.shape[0]
    LX, LY, LZ = grid.dims
    sb = cell_list.sorted_bins
    _, _, first = _runs(sb)
    slot = torch.arange(n, device=dev) - first

    Xp, Yp, Zp = LX + 2, LY + 2, LZ + 2
    bx, by, bz = sb // (LY * LZ), (sb // LZ) % LY, sb % LZ
    ok = slot < slots
    total = slots * Xp * Yp * Zp
    dest = torch.where(ok, ((slot * Xp + bx + 1) * Yp + by + 1) * Zp + bz + 1, total)
    far = kernels.far_fill(dtype)
    rasters = []
    for d, bc in enumerate((bx + x0, by, bz)):
        corner = kernels.grid_coord(bc, grid.min[d], grid.bin_size, dtype)
        frac = cell_list.sorted_positions[d] - corner
        rasters.append(kernels.scatter_table(dest, frac, total, far, (slots, Xp, Yp, Zp)))
    rho_sorted = _sweep_readback(
        rasters, slot, bx, by, bz, ok, LX, grid.bin_size, compact_support_radius
    )
    rho = torch.empty_like(rho_sorted)
    rho[cell_list.order] = rho_sorted
    if overflow_capacity:
        rho = _overflow_correction(
            positions, grid, cell_list, slots, candidate_capacity,
            compact_support_radius, rho, overflow_capacity,
        )
    return kernels.rounded(particle_rest_mass, dtype) * rho


def _octant_phase(positions: torch.Tensor, period: float) -> np.ndarray:
    """Per-axis circular mean of ``x mod period``: the dominant particle
    phase, used to center half-bin octants on the particle lattice."""
    s = kernels.rounded(period, positions.dtype)
    phis = []
    for d in range(3):
        x = positions[:, d]
        frac = x - s * torch.floor(x / s)
        ang = frac * (2.0 * math.pi) / s
        phis.append(torch.atan2(torch.sin(ang).sum(), torch.cos(ang).sum()))
    return to_host(torch.stack(phis) / (2.0 * math.pi) * s).numpy()


def _phase_aligned_bingrid(aabb_min, aabb_max, bin_size: float, phases) -> BinGrid:
    """BinGrid whose half-bin octant centers sit on the dominant particle
    phase per axis, so near-rest fluids land one particle per octant
    wherever their AABB falls. Covers the domain with >= one bin margin,
    like ``BinGrid.for_domain``."""
    s = float(bin_size) / 2.0
    mn = np.asarray(aabb_min, np.float64) - bin_size
    mx = np.asarray(aabb_max, np.float64) + bin_size
    # the estimate needs only ~s/4 accuracy; quantizing to s/4096 makes
    # reductions summed in different orders give the identical lattice
    q = s / 4096.0
    phases = np.round(np.asarray(phases, np.float64) / q) * q
    o = phases - s / 2.0
    k = np.ceil((o - mn) / s)
    origin = o - k * s  # largest octant-phase-aligned origin <= mn
    dims = np.maximum(np.ceil((mx - origin) / bin_size).astype(np.int64), 1)
    dims = [_bucket_lattice_dim(int(d)) for d in dims]
    total = int(dims[0]) * int(dims[1]) * int(dims[2])
    if total >= 2**31:
        raise ValueError(f"bin lattice too large: {tuple(dims)}")
    return BinGrid(
        min=tuple(origin.tolist()),
        bin_size=float(bin_size),
        dims=tuple(int(d) for d in dims),
    )


def geoslot_rasters(positions, grid: BinGrid, x_lo: int = 0, nx: Optional[int] = None):
    """The geoslot bin rasters: slot = half-bin octant of the particle.

    Returns ``(rasters, (slot, bx, by, bz), ok)``: three (8, LX+2, LY+2,
    LZ+2) fraction rasters, each particle's raster address, and a device
    bool that holds when every particle lies inside the lattice and alone
    in its octant. The flag is computed from the slot counts alone: on a
    collision the frac scatters see duplicate indices and their values are
    unspecified, but the flag discards them.

    With ``x_lo`` and ``nx`` the rasters hold the lattice's x-planes
    [x_lo, x_lo + nx) only, and ``bx`` counts from x_lo: every particle
    given must lie in them (the sharded densities' slabs).
    """
    dtype = positions.dtype
    LX, LY, LZ = grid.dims
    Xp, Yp, Zp = (LX if nx is None else nx) + 2, LY + 2, LZ + 2
    bs_np = kernels.np_dtype(dtype).type(grid.bin_size)
    bs, half = float(bs_np), float(bs_np * bs_np.dtype.type(0.5))

    bcoord, frac, octant = [], [], []
    in_lattice = torch.ones((), dtype=torch.bool, device=positions.device)
    for d, dim in enumerate((LX, LY, LZ)):
        mn = kernels.rounded(grid.min[d], dtype)
        col = positions[:, d]
        raw = torch.floor((col - mn) / bs).clamp(-1, dim)
        in_lattice &= ~torch.any((raw < 0) | (raw >= dim))
        c = raw.clamp(0, dim - 1).to(torch.int64)
        f = col - kernels.grid_coord(c, grid.min[d], bs, dtype)
        bcoord.append(c)
        frac.append(f)
        octant.append((f >= half).to(torch.int64))
    bx, by, bz = bcoord
    bx = bx - x_lo
    slot = (octant[0] << 2) | (octant[1] << 1) | octant[2]

    total = 8 * Xp * Yp * Zp
    dest = ((slot * Xp + bx + 1) * Yp + by + 1) * Zp + (bz + 1)
    counts = torch.zeros(total, dtype=torch.int32, device=positions.device)
    counts.scatter_add_(0, dest, torch.ones_like(dest, dtype=torch.int32))
    no_collision = counts.max() <= 1
    far = kernels.far_fill(dtype)
    rasters = [
        kernels.scatter_table(dest, frac[d], total, far, (8, Xp, Yp, Zp))
        for d in range(3)
    ]
    return rasters, (slot, bx, by, bz), in_lattice & no_collision


def compute_particle_densities_geoslot(
    positions, grid: BinGrid, compact_support_radius, particle_rest_mass,
    x_lo: int = 0, nx: Optional[int] = None, device=None,
):
    """Sort-free SPH densities on a phase-aligned lattice (see
    :func:`geoslot_rasters`, also for ``x_lo`` and ``nx``). Returns ``(rho,
    ok)``; ``rho`` holds only when the device bool ``ok`` is true."""
    positions = on_device(positions, device=device)
    rasters, (slot, bx, by, bz), ok = geoslot_rasters(positions, grid, x_lo, nx)
    every = torch.ones_like(slot, dtype=torch.bool)
    LX = grid.dims[0] if nx is None else nx
    rho = _sweep_readback(
        rasters, slot, bx, by, bz, every, LX, grid.bin_size, compact_support_radius
    )
    return kernels.rounded(particle_rest_mass, positions.dtype) * rho, ok


def _round_up(n: int, m: int = 8) -> int:
    return ((max(int(n), 1) + m - 1) // m) * m


# Largest bin lattice that gets a dense rank table in the binned formulation;
# larger lattices look neighbour bins up by binary search.
RANK_TABLE_MAX = 1 << 24


def compute_particle_densities_binned(
    positions, grid: BinGrid, cell_list: CellList, compact_support_radius,
    particle_rest_mass, capacity: int, u_cap: int, overflow_capacity: int = 0,
    candidate_capacity: int = 0, occupied: Optional[int] = None, device=None,
):
    """SPH densities from the runs of the bin-sorted cell list.

    Occupied bins (in ascending bin id) own one row each, of the first
    ``occupied`` (the occupied-bin count, where the caller knows it) or all
    ``u_cap`` rows; ``u_cap`` is the occupied-bin count rounded up to a
    power of two, as in the reference. Every particle among the first K of
    its bin's run sums the kernel over the first K particles of each of
    the 27 bins around its own (self term included): kernel K5
    (``binned_sweep_cuda``) on the card, its plain (rows, K, K) pair-block
    loop on the CPU; nothing is read back. Neighbour bins come from a dense
    rank table on lattices up to ``RANK_TABLE_MAX`` bins, else from a
    binary search over the occupied bin ids.

    ``capacity`` (K) must cover the largest occupancy unless
    ``overflow_capacity`` is set: then the rank >= K particles are left out
    of the sums and corrected exactly (``_overflow_correction``, with
    ``candidate_capacity`` >= the largest occupancy).
    """
    positions, _ = on_device(positions, cell_list.order, device=device)
    K = capacity
    R = u_cap if occupied is None else min(int(occupied), u_cap)
    h = compact_support_radius
    tables = binned_sweep_inputs(grid, cell_list, R)
    with profile("binned sweep"):
        rho_sorted = binned_sweep_cuda(*cell_list.sorted_positions, *tables, K, grid.dims, h)
    rho = torch.empty_like(rho_sorted)
    rho[cell_list.order] = rho_sorted
    if overflow_capacity:
        rho = _overflow_correction(
            positions, grid, cell_list, K, candidate_capacity, h, rho, overflow_capacity
        )
    return kernels.rounded(particle_rest_mass, positions.dtype) * rho


def binned_sweep_inputs(grid: BinGrid, cell_list: CellList, rows: int):
    """The cell-list tables of ``binned_sweep_cuda`` for its first ``rows``
    occupied bins: (bin_rank, occ_bins, run_start, rank_table), the last
    None on lattices past ``RANK_TABLE_MAX`` bins; nothing is read back."""
    sb = cell_list.sorted_bins
    n = sb.shape[0]
    dev = sb.device
    R = int(rows)
    is_start, bin_rank, _ = _runs(sb)
    lattice = grid.lattice
    _, dy, dz = grid.dims
    # rows past the occupied bins hold a bin id whose every stencil target
    # lies past the lattice
    empty_row = lattice + dy * dz + dz + 2
    occ_bins = torch.full((R + 1,), empty_row, dtype=torch.int64, device=dev)
    occ_bins.scatter_(0, torch.where(is_start & (bin_rank < R), bin_rank, R), sb)
    occ_bins = occ_bins[:R]  # ascending
    # each rank's first sorted index, n past the occupied bins
    run_start = torch.full((R + 2,), n, dtype=torch.int64, device=dev)
    run_start.scatter_(
        0, torch.where(is_start & (bin_rank <= R), bin_rank, R + 1), torch.arange(n, device=dev)
    )
    rank_table = None
    if lattice <= RANK_TABLE_MAX:
        rank_table = torch.full((lattice + 1,), -1, dtype=torch.int64, device=dev)
        rank_table.scatter_(0, occ_bins.clamp_max(lattice), torch.arange(R, device=dev))
        rank_table = rank_table[:lattice]
    return bin_rank, occ_bins, run_start[: R + 1], rank_table


def binned_plan(n: int, lattice: int, n_bins: int, max_occ: int, over8: int) -> dict:
    """The binned formulation's capacities, as the reference picks them:
    K = 8 when no bin holds more ("binned8"); K = 8 with the overflow
    correction when the rank >= 8 particles are few and the lattice is
    small enough for its per-bin tables (also "binned8"); otherwise K = the
    largest occupancy rounded up to 8 ("binned"). ``u_cap`` is the
    occupied-bin count rounded up to a power of two; ``ocap`` the size of
    the overflow lists (:func:`overflow_lists_capacity`)."""
    u_cap = 1 << max(int(n_bins) - 1, 1).bit_length()
    plan = dict(kind="binned8", capacity=8, u_cap=u_cap, overflow=False, ocap=0, ccap=0)
    if max_occ <= 8:
        return plan
    if over8 <= density_over_budget(n) and lattice <= RANK_TABLE_MAX:
        return dict(plan, overflow=True, ocap=overflow_lists_capacity(over8),
                    ccap=_round_up(max_occ + 8))
    return dict(plan, kind="binned", capacity=_round_up(max_occ))


def overflow_lists_capacity(over8: int) -> int:
    """The overflow correction's list size for ``over8`` rank >= 8
    particles: twice their count, at least 256, in steps of 256 (headroom
    for the next frames of a plan; reference ``neighbors.py:1454-1458``)."""
    return _round_up(max(2 * int(over8), 256), 256)


def density_over_budget(n: int) -> int:
    """Past this many rank >= 8 particles the K=8 paths stop paying off."""
    return max(4096, int(n) // 128)


def density_phase_retry(n: int, over8: int) -> bool:
    """Whether to retry binning with the origin shifted by half a bin (a
    fluid resting on a 2r lattice can tie-break onto bin boundaries)."""
    return over8 > density_over_budget(n)


def phase_shifted_bingrid(grid: BinGrid, compact_support_radius: float) -> BinGrid:
    """The half-bin-shifted retry lattice for :func:`density_phase_retry`."""
    half = compact_support_radius / 2.0
    return BinGrid(
        min=tuple(m - half for m in grid.min),
        bin_size=grid.bin_size,
        dims=tuple(_bucket_lattice_dim(d + 1) for d in grid.dims),
    )


# The reference's geoslot switch, read at each call: "0" skips the geoslot
# attempt (the sorted formulations run instead).
GEOSLOT_ENV = "SPLASHSURF_TPU_DENSITY_GEOSLOT"


def density_gate(
    n: int, lattice: int, n_bins: int, max_occ: int, over8: int, which: str = "single"
) -> dict:
    """Pick the density formulation from the binning statistics, as the
    reference package does: ``try_geoslot`` (still subject to the octant
    check; off when ``SPLASHSURF_TPU_DENSITY_GEOSLOT`` is not "1" and after
    the hysteresis below has seen too many consecutive collisions),
    ``use_raster`` (with the overflow correction capacity ``ccap`` when
    max_occ > 8); otherwise the sparse binned formulation. The single-device
    and the sharded wrappers share it, so that both take the same
    formulation on the same scene; the decision and its statistics are
    recorded as ``LAST_GATE[which]``."""
    dense_enough = lattice <= GATE_LATTICE_MAX and n_bins >= lattice // 4
    use_raster = dense_enough and (max_occ <= 8 or over8 <= density_over_budget(n))
    decision = dict(
        try_geoslot=(
            dense_enough and os.environ.get(GEOSLOT_ENV, "1") == "1" and _geoslot_wanted()
        ),
        use_raster=use_raster,
        overflow=use_raster and max_occ > 8,
        ocap=overflow_lists_capacity(over8) if use_raster and max_occ > 8 else 0,
        ccap=_round_up(max_occ + 8) if use_raster and max_occ > 8 else 0,
    )
    LAST_GATE[which] = dict(
        decision, n=n, lattice=lattice, n_bins=n_bins, max_occ=max_occ, over8=over8
    )
    return decision


# Geoslot hysteresis (reference ``neighbors.py:1463-1483``): a scene that
# keeps colliding (a compressed fluid) pays a failed octant attempt on every
# call. After _GEOSLOT_MAX_CONSECUTIVE_MISSES consecutive collisions the gate
# stops offering geoslot for the rest of the process; a success resets the
# count. Both wrappers note an outcome only for an attempt that ran, on a
# phase-aligned lattice within GATE_LATTICE_MAX. The state is process-global,
# as in the reference: it decides which formulation runs, so the two packages
# take the same one after the same calls.
_GEOSLOT_MISSES = [0]
_GEOSLOT_MAX_CONSECUTIVE_MISSES = 3


def _geoslot_wanted() -> bool:
    return _GEOSLOT_MISSES[0] < _GEOSLOT_MAX_CONSECUTIVE_MISSES


def _note_geoslot_outcome(ok: bool) -> None:
    _GEOSLOT_MISSES[0] = 0 if ok else _GEOSLOT_MISSES[0] + 1


def reset_geoslot_hysteresis() -> None:
    _GEOSLOT_MISSES[0] = 0


# The last density call: the formulation it took ("geoslot", "raster",
# "binned8" or "binned"; "cellraster" for the dense route's cell-raster
# frames) under "kind", and the statistics it was chosen from ("n",
# "lattice", "n_bins", "max_occ", "over8"). "single" and "sharded" hold each
# wrapper's last gate decision with its "kind" ("replicated" where the
# sharded wrapper handed the call to the single-device one). Read by tests
# and chip_smoke.py; never by the pipeline.
LAST_GATE: dict = {}

_GATE_STATS = ("n", "lattice", "n_bins", "max_occ", "over8")


def note_formulation(which: str, kind: str) -> None:
    """Record that the ``which`` wrapper took the formulation ``kind``; a
    formulation that ran ("replicated" hands over and records nothing more)
    also becomes the top-level record."""
    LAST_GATE[which]["kind"] = kind
    if kind != "replicated":
        LAST_GATE["kind"] = kind
        LAST_GATE.update({k: LAST_GATE[which][k] for k in _GATE_STATS})


class DensityPlanMiss(RuntimeError):
    """A speculative density plan was violated; clear and recompute."""


def clear_density_plan() -> None:
    """Forget the density plans, and drop the warm frames' CUDA graphs
    (each was captured on one): ``plans.clear_density``."""
    plans.clear_density()


def _lattice_end(grid: BinGrid, d: int, dtype) -> float:
    """min + dims * bin_size along axis ``d`` in ``dtype``, rounded once."""
    t = kernels.np_dtype(dtype).type
    return kernels.rounded(
        float(t(grid.min[d])) + grid.dims[d] * float(t(grid.bin_size)), dtype
    )


def _plan_check(positions, sorted_bins, grid: BinGrid, kind: str, slots: int,
                u_cap: int, ocap: int, ccap: int = 0) -> torch.Tensor:
    """Device bool: every particle lies inside the plan's lattice (no bin is
    clipped) and the plan's capacities still hold (reference ``_plan_check``,
    ``neighbors.py:1108-1141``)."""
    lo, hi = torch.aminmax(positions, dim=0)
    ok = torch.ones((), dtype=torch.bool, device=positions.device)
    for d in range(3):
        ok &= (lo[d] >= kernels.rounded(grid.min[d], positions.dtype)) & (
            hi[d] < _lattice_end(grid, d, positions.dtype)
        )
    mx, u, o8 = _bin_stats_device(sorted_bins)
    ok &= u <= u_cap
    fits = mx <= slots
    if kind in ("raster", "binned8") and ocap > 0:
        # the overflow lists and the candidate gathers have fixed sizes:
        # drifting past either must miss the plan, not corrupt the sums
        fits |= (o8 <= ocap) & (mx <= max(ccap, slots))
    return ok & fits


def _densities_planned(positions, compact_support_radius, particle_rest_mass, plan):
    """A plan hit: the plan's formulation on its lattice and capacities,
    with nothing read back. Returns (rho, check), the device bool of
    :func:`_plan_check` (for geoslot, the octant check)."""
    grid, kind = plan["grid"], plan["kind"]
    if kind == "geoslot":
        return compute_particle_densities_geoslot(
            positions, grid, compact_support_radius, particle_rest_mass
        )
    cl = build_cell_list(positions, grid)
    check = _plan_check(
        positions, cl.sorted_bins, grid, kind, plan["slots"], plan["u_cap"],
        plan["ocap"], plan["ccap"],
    )
    common = (positions, grid, cl, compact_support_radius, particle_rest_mass)
    if kind == "raster":
        rho = compute_particle_densities_raster(
            *common, slots=plan["slots"], overflow_capacity=plan["ocap"],
            candidate_capacity=plan["ccap"],
        )
    else:
        rho = compute_particle_densities_binned(
            *common, capacity=plan["slots"], u_cap=plan["u_cap"],
            overflow_capacity=plan["ocap"], candidate_capacity=plan["ccap"],
        )
    return rho, check


def compute_particle_densities(
    positions,
    compact_support_radius: float,
    particle_rest_mass: float,
    capacity: Optional[int] = None,
    speculate: bool = False,
    n_valid: Optional[int] = None,
    device=None,
):
    """Per-particle SPH densities (self term included) on the positions'
    device (reference ``neighbors.py:1197-1375``). Plans the bin lattice on
    the host from a few scalars read back, then runs geoslot, else the
    raster formulation, else the binned one; an explicit ``capacity`` takes
    the binned formulation with at least that many slots per bin.

    With ``speculate=True`` returns ``(rho, check)``. A frame with no plan
    for its key plans (reads back) and records the plan; ``check`` is then
    None. A frame with a plan runs on it and reads nothing back; ``check``
    is a device bool that the caller must verify before it trusts ``rho``,
    and on False clear the plan (:func:`clear_density_plan`) and recompute.

    Only the first ``n_valid`` rows are particles, where that is given; the
    densities of the rows past them are 0. An array goes to ``device``
    (``placement.on_device``).
    """
    positions = on_device(positions, device=device)
    n = positions.shape[0]
    if n_valid is not None and int(n_valid) < n:
        out = compute_particle_densities(
            positions[: int(n_valid)], compact_support_radius, particle_rest_mass,
            capacity, speculate,
        )
        rho = out[0] if speculate else out
        rho = torch.cat([rho, rho.new_zeros(n - rho.shape[0])])
        return (rho, out[1]) if speculate else rho

    key = plans.density_key(n, str(positions.dtype), compact_support_radius, capacity)
    plan = plans.DENSITY_PLAN.get(key) if speculate else None
    if plan is not None:
        LAST_GATE["kind"] = plan["kind"]
        return _densities_planned(
            positions, compact_support_radius, particle_rest_mass, plan
        )

    def planned(rho, grid, kind, slots=8, u_cap=0, ocap=0, ccap=0):
        if not speculate:
            return rho
        plans.DENSITY_PLAN[key] = dict(
            grid=grid, kind=kind, slots=slots, u_cap=u_cap, ocap=ocap, ccap=ccap
        )
        return rho, None

    mn, mx = to_host(torch.stack(torch.aminmax(positions, dim=0))).numpy()
    grid = BinGrid.for_domain(mn, mx, compact_support_radius)
    cl = build_cell_list(positions, grid)
    max_occ, n_bins, over8 = bin_stats_ex(cl)
    if capacity is None and density_phase_retry(n, over8):
        grid2 = phase_shifted_bingrid(grid, compact_support_radius)
        cl2 = build_cell_list(positions, grid2)
        stats2 = bin_stats_ex(cl2)
        if stats2[2] < over8:
            grid, cl = grid2, cl2
            max_occ, n_bins, over8 = stats2
    u_cap = 1 << max(int(n_bins) - 1, 1).bit_length()

    if capacity is not None:
        # the reference's explicit capacity: binned, never truncated
        K = capacity if capacity >= max_occ else _round_up(max_occ)
        LAST_GATE["kind"] = "binned"
        rho = compute_particle_densities_binned(
            positions, grid, cl, compact_support_radius, particle_rest_mass,
            capacity=K, u_cap=u_cap, occupied=n_bins,
        )
        return planned(rho, grid, "binned", K, u_cap)

    gate = density_gate(n, grid.lattice, n_bins, max_occ, over8)
    if gate["try_geoslot"]:
        phases = _octant_phase(positions, compact_support_radius / 2.0)
        agrid = _phase_aligned_bingrid(mn, mx, compact_support_radius, phases)
        if agrid.lattice <= GATE_LATTICE_MAX:
            rho, ok = compute_particle_densities_geoslot(
                positions, agrid, compact_support_radius, particle_rest_mass
            )
            ok = bool(to_host(ok))
            _note_geoslot_outcome(ok)
            if ok:
                note_formulation("single", "geoslot")
                return planned(rho, agrid, "geoslot", 8, u_cap)
        # octant collisions: the sorted formulations below
    if gate["use_raster"]:
        note_formulation("single", "raster")
        rho = compute_particle_densities_raster(
            positions, grid, cl, compact_support_radius, particle_rest_mass,
            slots=8, overflow_capacity=gate["ocap"], candidate_capacity=gate["ccap"],
        )
        return planned(rho, grid, "raster", 8, u_cap, gate["ocap"], gate["ccap"])
    plan = binned_plan(n, grid.lattice, n_bins, max_occ, over8)
    note_formulation("single", plan["kind"])
    rho = compute_particle_densities_binned(
        positions, grid, cl, compact_support_radius, particle_rest_mass,
        capacity=plan["capacity"], u_cap=u_cap, overflow_capacity=plan["ocap"],
        candidate_capacity=plan["ccap"], occupied=n_bins,
    )
    return planned(rho, grid, plan["kind"], plan["capacity"], u_cap, plan["ocap"], plan["ccap"])


# ---------------------------------------------------------------------------
# neighbour lists (neighbors.py:149-153, 194-445 of the reference)
# ---------------------------------------------------------------------------

# Candidate slots (queries x 27 bins x capacity) of one chunk of the
# neighbour search: each slot holds an int64 index, a mask bit and the
# squared distance, so one chunk's working set stays near 0.5 GB in f32.
NEIGHBOR_CHUNK_SLOTS = 1 << 24


def max_bin_occupancy(cell_list: CellList) -> int:
    """Largest particle count in any bin (one read-back; it sets the gather
    capacity)."""
    return bin_stats(cell_list)[0]


def _neighbor_chunks(positions, grid: BinGrid, cell_list: CellList, radius, capacity: int):
    """The neighbour search in chunks of queries, in index order: yields
    (first query, candidate indices (M, 27*capacity), within) per chunk,
    ``within`` marking the candidates at d^2 < r^2 that are not the query
    itself. Candidates come stencil offset major, bin-sorted order minor,
    as the reference enumerates them. A chunk holds at most
    ``NEIGHBOR_CHUNK_SLOTS`` candidate slots, read at each call."""
    dev = positions.device
    n = positions.shape[0]
    r = kernels.np_dtype(positions.dtype).type(radius)
    r2 = float(r * r)
    tables = _segment_tables(cell_list.sorted_bins, grid.lattice)
    rows = max(1, NEIGHBOR_CHUNK_SLOTS // (27 * capacity))
    for q0 in range(0, n, rows):
        query = positions[q0 : q0 + rows]
        idx, mask = gather_candidates(query, grid, cell_list, capacity, tables)
        d2 = None
        for d in range(3):
            diff = positions[:, d][idx] - query[:, d, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        own = torch.arange(q0, q0 + query.shape[0], device=dev)[:, None]
        yield q0, idx, mask & (idx != own) & (d2 < r2)


def neighbor_counts_and_distsq(positions, grid: BinGrid, cell_list: CellList, radius,
                               capacity: int, device=None) -> torch.Tensor:
    """Neighbour counts within ``radius`` per particle, self excluded
    ((N,) int32)."""
    positions, _ = on_device(positions, cell_list.order, device=device)
    return torch.cat([
        w.sum(dim=1)
        for _, _, w in _neighbor_chunks(positions, grid, cell_list, radius, capacity)
    ]).to(torch.int32)


def neighbor_lists_padded(positions, grid: BinGrid, cell_list: CellList, radius,
                          capacity: int, max_neighbors: int, device=None):
    """Fixed-width neighbour lists: (N, max_neighbors) int32, -1 padded, and
    the full counts (N,) int32 (a row keeps its first ``max_neighbors``
    neighbours in candidate order). Use :func:`to_csr` for ragged lists."""
    positions, _ = on_device(positions, cell_list.order, device=device)
    n = positions.shape[0]
    out = torch.full((n, max_neighbors), -1, dtype=torch.int32, device=positions.device)
    counts = []
    for q0, idx, within in _neighbor_chunks(positions, grid, cell_list, radius, capacity):
        rank = torch.cumsum(within, dim=1) - 1
        keep = within & (rank < max_neighbors)
        row = torch.nonzero(keep)[:, 0] + q0
        out[row, rank[keep]] = idx[keep].to(torch.int32)
        counts.append(within.sum(dim=1))
    return out, torch.cat(counts).to(torch.int32)


def neighbor_lists_csr(positions, grid: BinGrid, cell_list: CellList, radius,
                       capacity: int, max_neighbors: Optional[int] = None):
    """Ragged neighbour lists on the device: (counts (N,) int64, indices
    (sum of counts,) int32), each row in candidate order and cut to its
    first ``max_neighbors`` where that is given."""
    counts, indices = [], []
    for _, idx, within in _neighbor_chunks(positions, grid, cell_list, radius, capacity):
        if max_neighbors is not None:
            within &= torch.cumsum(within, dim=1) <= max_neighbors
        counts.append(within.sum(dim=1))
        indices.append(idx[within].to(torch.int32))
    return torch.cat(counts), torch.cat(indices)


def to_csr(padded_lists: np.ndarray, counts: np.ndarray):
    """Padded neighbour lists to CSR (offsets, indices) on the host."""
    counts = np.asarray(counts)
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    padded = np.asarray(padded_lists)
    width = padded.shape[1] if padded.ndim == 2 else 0
    mask = np.arange(width)[None, :] < counts[:, None]
    indices = padded[mask].astype(np.int32)  # row-major: keeps the order
    return offsets, indices


class NeighborhoodLists(list):
    """Per-particle neighbour lists (pysplashsurf parity): a list of
    per-particle int32 index arrays; ``offsets`` / ``indices`` give the CSR
    form."""

    def get_neighborhood_lists(self):
        return [list(map(int, a)) for a in self]

    @property
    def offsets(self) -> np.ndarray:
        off = np.zeros(len(self) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in self], out=off[1:])
        return off

    @property
    def indices(self) -> np.ndarray:
        if not len(self):
            return np.zeros(0, np.int32)
        return np.concatenate([np.asarray(a) for a in self]).astype(np.int32)

    @staticmethod
    def from_csr(offsets, indices) -> "NeighborhoodLists":
        bounds = np.asarray(offsets).tolist()
        return NeighborhoodLists(indices[a:b] for a, b in zip(bounds[:-1], bounds[1:]))


def neighbor_search_csr(positions: torch.Tensor, radius: float,
                        max_neighbors: Optional[int] = 256, domain=None):
    """The device part of the neighbour search: (counts (N,) int64, indices
    int32) on the positions' device, each list in candidate order and cut to
    its first ``max_neighbors``. The bin lattice (bin size ``radius``)
    covers ``domain`` (an ``Aabb3d``) where given, else the particles."""
    if domain is not None:
        mn, mx = domain.mins, domain.maxs
    else:
        lo, hi = torch.aminmax(positions, dim=0)
        mn, mx = lo.cpu().numpy(), hi.cpu().numpy()
    grid = BinGrid.for_domain(mn, mx, radius)
    cl = build_cell_list(positions, grid)
    capacity = _round_up(max_bin_occupancy(cl))
    return neighbor_lists_csr(positions, grid, cl, radius, capacity, max_neighbors)


def lists_from_device_csr(counts: torch.Tensor, indices: torch.Tensor) -> NeighborhoodLists:
    """``NeighborhoodLists`` on the host from the device CSR of
    :func:`neighbor_search_csr` (one copy of each array)."""
    offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts.cpu().numpy(), out=offsets[1:])
    return NeighborhoodLists.from_csr(offsets, indices.cpu().numpy())


def neighborhood_search_spatial_hashing_parallel(
    positions, radius=None, max_neighbors: int = 256, search_radius=None, device=None
) -> NeighborhoodLists:
    """Neighbour lists of all particles within the search radius, self
    excluded (pysplashsurf's ``neighborhood_search_spatial_hashing_parallel``):
    ``(positions, radius)``, or the reference's ``(positions, domain:
    Aabb3d, search_radius)``, whose bin lattice covers the domain. Each list
    keeps its first ``max_neighbors`` neighbours (256, as the reference).

    The search runs on the positions' device (a tensor stays on its own;
    anything else goes to ``device``, by default CUDA) over the sorted bin
    lattice, in chunks of ``NEIGHBOR_CHUNK_SLOTS`` candidate slots; the
    lists come to the host as one CSR copy."""
    positions = on_device(positions, device=device).contiguous()
    domain = None
    if isinstance(radius, Aabb3d) or radius is None:
        domain = radius
        if search_radius is None:
            if isinstance(max_neighbors, (int, np.integer)):
                raise TypeError("search_radius required with a domain AABB")
            search_radius, max_neighbors = max_neighbors, 256
        radius = search_radius
    return lists_from_device_csr(
        *neighbor_search_csr(positions, float(radius), max_neighbors, domain)
    )


def particle_neighbor_lists(positions: torch.Tensor, parameters):
    """``SurfaceReconstruction.particle_neighbors`` of a route: the lists
    within the compact support radius when
    ``parameters.global_neighborhood_list`` asks for them, else None."""
    if not parameters.global_neighborhood_list:
        return None
    return neighborhood_search_spatial_hashing_parallel(
        positions, parameters.compact_support_radius
    )


@dataclasses.dataclass
class NeighborhoodStats:
    """Neighbour-count statistics (neighborhood_search.rs:604-646)."""

    histogram: np.ndarray  # histogram[k] = number of particles with k neighbours
    particles_with_neighbors: int
    max_neighbors: int
    avg_neighbors: float  # mean over the particles with at least one neighbour

    def __str__(self) -> str:
        lines = [
            f"Max neighbors: {self.max_neighbors}, avg neighbors: "
            f"{self.avg_neighbors:.3f}, particles with neighbors: "
            f"{self.particles_with_neighbors}",
            "Histogram:",
        ]
        lines += [f"{i:2d} neighbors: {int(c):10d}" for i, c in enumerate(self.histogram)]
        return "\n".join(lines)


def compute_neighborhood_stats(neighborhood_lists) -> NeighborhoodStats:
    """Histogram, maximum and mean of the per-particle neighbour counts, of
    ragged lists (as ``neighborhood_search_spatial_hashing_parallel``
    returns them) or of a flat array of counts (``compute_neigborhood_stats``,
    neighborhood_search.rs:604-646)."""
    if isinstance(neighborhood_lists, (list, tuple)):
        counts = np.asarray([len(a) for a in neighborhood_lists], np.int64)
    else:
        counts = np.asarray(neighborhood_lists, np.int64)
    hist = np.bincount(counts) if len(counts) else np.zeros(1, np.int64)
    with_n = int(np.count_nonzero(counts))
    return NeighborhoodStats(
        histogram=hist,
        particles_with_neighbors=with_n,
        max_neighbors=int(counts.max()) if len(counts) else 0,
        avg_neighbors=float(counts.sum() / with_n) if with_n else 0.0,
    )


def neighborhood_search_naive(positions: np.ndarray, radius: float):
    """O(N^2) oracle on the host (neighborhood_search.rs:72-91)."""
    p = np.asarray(positions, dtype=np.float64)
    d2 = np.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
    within = (d2 < radius * radius) & ~np.eye(len(p), dtype=bool)
    return [np.nonzero(row)[0] for row in within]
