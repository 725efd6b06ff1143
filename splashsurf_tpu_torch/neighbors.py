"""Per-particle SPH densities on a bin lattice (PyTorch port of the density
path of ``splashsurf_tpu.neighbors``).

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

3. binned: particles sorted by bin fill one (u_cap, K) position table row
   per occupied bin, and each of the 27 stencil offsets adds a (K, K) pair
   block per occupied bin (plain PyTorch; the reference has no TPU kernel
   here). With K = 8 and a few fuller bins, their rank >= 8 particles go
   through the same exact overflow correction as the raster formulation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.ops.splat_kernels import density_sweep_cuda

# Largest materializable bin lattice for the raster/geoslot formulations.
GATE_LATTICE_MAX = 8_000_000


def _bucket_lattice_dim(n: int) -> int:
    """Round a bin-lattice dimension up to its bucket (32 steps per octave).
    Kept so that the port builds the same lattice as the reference package,
    whose density gate reads the bucketed size; padded bins are empty."""
    if n <= 4:
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

    def bin_ijk(self, positions: torch.Tensor) -> torch.Tensor:
        """(M, 3) int64 bin indices, clipped into the lattice."""
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


_STENCIL = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int64,
)


def build_cell_list(positions: torch.Tensor, grid: BinGrid) -> CellList:
    """Sort particles by flat bin id with a stable sort."""
    bins = grid.flatten(grid.bin_ijk(positions))
    sorted_bins, order = torch.sort(bins, stable=True)
    return CellList(
        order=order,
        sorted_bins=sorted_bins,
        sorted_positions=tuple(positions[:, d][order] for d in range(3)),
    )


def bin_stats(cell_list: CellList) -> Tuple[int, int, int]:
    """(max occupancy, occupied bins, particles with bin rank >= 8), read
    back to the host in one transfer."""
    _, counts = torch.unique_consecutive(cell_list.sorted_bins, return_counts=True)
    stats = torch.stack(
        [counts.max(), torch.tensor(counts.numel(), device=counts.device),
         torch.clamp_min(counts - 8, 0).sum()]
    )
    mx, u, o8 = stats.tolist()
    return int(mx), int(u), int(o8)


def _segment_tables(sorted_bins: torch.Tensor, lattice: int):
    """Dense per-bin (first sorted index, count) tables over the lattice."""
    n = sorted_bins.shape[0]
    dev = sorted_bins.device
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_bins[1:] != sorted_bins[:-1]
    first = torch.nonzero(is_start).squeeze(1)
    starts = torch.zeros(lattice, dtype=torch.int64, device=dev)
    starts[sorted_bins[first]] = first
    counts = torch.bincount(sorted_bins, minlength=lattice)
    return starts, counts


def gather_candidates(query, grid: BinGrid, cell_list: CellList, capacity: int, tables):
    """Candidate particle indices from the 27-bin stencil of each query.

    Returns (idx (M, 27*capacity) into the original order, mask (M,
    27*capacity)), stencil offset major and bin-sorted order minor."""
    starts_table, counts_table = tables
    dev = query.device
    dims = torch.tensor(grid.dims, device=dev)
    nb = grid.bin_ijk(query)[:, None, :] + torch.as_tensor(_STENCIL, device=dev)[None]
    valid = torch.all((nb >= 0) & (nb < dims), dim=-1)
    nb_flat = grid.flatten(torch.minimum(torch.clamp_min(nb, 0), dims - 1))
    starts = starts_table[nb_flat]
    counts = torch.where(valid, counts_table[nb_flat], 0)
    slot = torch.arange(capacity, device=dev)
    n = cell_list.order.shape[0]
    gather_pos = torch.clamp(starts[:, :, None] + slot, 0, max(n - 1, 0))
    mask = slot < counts[:, :, None]
    idx = cell_list.order[gather_pos]
    return idx.reshape(idx.shape[0], -1), mask.reshape(mask.shape[0], -1)


def _overflow_correction(positions, grid, cell_list, K, capacity, h, rho):
    """Exact correction for particles of within-bin rank >= K, which the
    dense tables leave out: their own density is summed over full candidate
    gathers (self term included), and their contribution is added into the
    table particles. Lists are compacted to their exact sizes.

    The index_add_ sums run with atomics on CUDA, so their order, and the
    last bits of the corrected densities, change from run to run."""
    dtype = positions.dtype
    dev = positions.device
    tables = _segment_tables(cell_list.sorted_bins, grid.lattice)
    starts_table, counts_table = tables
    obin = torch.nonzero(counts_table > K).squeeze(1)  # ascending bin id
    base = starts_table[obin]
    cnt = counts_table[obin]
    rr = torch.arange(K, capacity, device=dev)
    osid = (base[:, None] + rr[None, :])[rr[None, :] < cnt[:, None]]
    opos = [cell_list.sorted_positions[d][osid] for d in range(3)]
    oidx = cell_list.order[osid]

    idx, cmask = gather_candidates(
        torch.stack(opos, dim=1), grid, cell_list, capacity, tables
    )
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
    return rho.index_add(0, oidx, rho_over)


def _sweep_readback(rasters, slot, bx, by, bz, ok, grid, h):
    """Bin sweep (kernel K2) and per-particle read-back of its sums."""
    LX, _, _ = grid.dims
    Zp = rasters[0].shape[3]
    acc = density_sweep_cuda(*rasters, LX, grid.bin_size, h)
    width = acc.shape[2]
    src = torch.where(ok, (slot * LX + bx) * width + by * Zp + bz, 0)
    return torch.where(ok, acc.reshape(-1)[src], 0.0)


def compute_particle_densities_raster(
    positions, grid: BinGrid, cell_list: CellList, compact_support_radius,
    particle_rest_mass, slots: int = 8, overflow: bool = False,
    candidate_capacity: int = 0,
):
    """SPH densities via the dense bin-raster sweep, slots from the
    within-bin rank of the bin-sorted order; with ``overflow`` the rank >=
    ``slots`` particles go through the exact overflow correction."""
    dtype = positions.dtype
    dev = positions.device
    n = positions.shape[0]
    LX, LY, LZ = grid.dims
    sb = cell_list.sorted_bins
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sb[1:] != sb[:-1]
    run_first = torch.nonzero(is_start).squeeze(1)
    run_id = torch.cumsum(is_start, 0) - 1
    slot = torch.arange(n, device=dev) - run_first[run_id]

    Xp, Yp, Zp = LX + 2, LY + 2, LZ + 2
    bx, by, bz = sb // (LY * LZ), (sb // LZ) % LY, sb % LZ
    ok = slot < slots
    total = slots * Xp * Yp * Zp
    dest = torch.where(ok, ((slot * Xp + bx + 1) * Yp + by + 1) * Zp + bz + 1, total)
    far = kernels.far_fill(dtype)
    rasters = []
    for d, bc in enumerate((bx, by, bz)):
        corner = kernels.grid_coord(bc, grid.min[d], grid.bin_size, dtype)
        frac = cell_list.sorted_positions[d] - corner
        rasters.append(kernels.scatter_table(dest, frac, total, far, (slots, Xp, Yp, Zp)))
    rho_sorted = _sweep_readback(
        rasters, slot, bx, by, bz, ok, grid, compact_support_radius
    )
    rho = torch.empty_like(rho_sorted)
    rho[cell_list.order] = rho_sorted
    if overflow:
        rho = _overflow_correction(
            positions, grid, cell_list, slots, candidate_capacity,
            compact_support_radius, rho,
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
    return (torch.stack(phis) / (2.0 * math.pi) * s).cpu().numpy()


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


def geoslot_rasters(positions, grid: BinGrid):
    """The geoslot bin rasters: slot = half-bin octant of the particle.

    Returns ``(rasters, (slot, bx, by, bz), ok)``: three (8, LX+2, LY+2,
    LZ+2) fraction rasters, each particle's raster address, and a device
    bool that holds when every particle lies inside the lattice and alone
    in its octant. The flag is computed from the slot counts alone: on a
    collision the frac scatters see duplicate indices and their values are
    unspecified, but the flag discards them.
    """
    dtype = positions.dtype
    LX, LY, LZ = grid.dims
    Xp, Yp, Zp = LX + 2, LY + 2, LZ + 2
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
    slot = (octant[0] << 2) | (octant[1] << 1) | octant[2]

    total = 8 * Xp * Yp * Zp
    dest = ((slot * Xp + bx + 1) * Yp + by + 1) * Zp + (bz + 1)
    no_collision = torch.bincount(dest, minlength=total).max() <= 1
    far = kernels.far_fill(dtype)
    rasters = [
        kernels.scatter_table(dest, frac[d], total, far, (8, Xp, Yp, Zp))
        for d in range(3)
    ]
    return rasters, (slot, bx, by, bz), in_lattice & no_collision


def compute_particle_densities_geoslot(
    positions, grid: BinGrid, compact_support_radius, particle_rest_mass
):
    """Sort-free SPH densities on a phase-aligned lattice (see
    :func:`geoslot_rasters`). Returns ``(rho, ok)``; ``rho`` holds only
    when the device bool ``ok`` is true."""
    rasters, (slot, bx, by, bz), ok = geoslot_rasters(positions, grid)
    every = torch.ones_like(slot, dtype=torch.bool)
    rho = _sweep_readback(rasters, slot, bx, by, bz, every, grid, compact_support_radius)
    return kernels.rounded(particle_rest_mass, positions.dtype) * rho, ok


def _round_up(n: int, m: int = 8) -> int:
    return ((max(int(n), 1) + m - 1) // m) * m


# Largest bin lattice that gets a dense rank table in the binned formulation;
# larger lattices look neighbour bins up by binary search.
RANK_TABLE_MAX = 1 << 24

# Bound on the elements of one (K, K, rows) pair block of the binned sweep.
_PAIR_BLOCK_ELEMS = 1 << 25


def compute_particle_densities_binned(
    positions, grid: BinGrid, cell_list: CellList, compact_support_radius,
    particle_rest_mass, capacity: int, u_cap: int, overflow: bool = False,
    candidate_capacity: int = 0,
):
    """SPH densities from per-occupied-bin position tables.

    Occupied bins (in ascending bin id) own one row of (u_cap, K) position
    tables, empty slots holding the far sentinel. Each of the 27 stencil
    offsets adds, for every occupied bin, the (K, K) block of kernel values
    between its slots and those of the neighbour bin; empty slots add
    exactly 0 and the self term W(0) comes in naturally. ``u_cap`` is the
    occupied-bin count rounded up to a power of two, as in the reference;
    only the occupied rows are swept, in row blocks that bound the pair
    block to ``_PAIR_BLOCK_ELEMS``. Neighbour rows come from a dense rank
    table on lattices up to ``RANK_TABLE_MAX`` bins, else from a binary
    search over the occupied bin ids.

    ``capacity`` (K) must cover the largest occupancy unless ``overflow``
    is set: then the rank >= K particles are left out of the tables and
    corrected exactly (``_overflow_correction``, with ``candidate_capacity``
    >= the largest occupancy).
    """
    dtype = positions.dtype
    dev = positions.device
    n = positions.shape[0]
    K = capacity
    sb = cell_list.sorted_bins
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sb[1:] != sb[:-1]
    bin_rank = torch.cumsum(is_start, 0) - 1
    first = torch.nonzero(is_start).squeeze(1)
    n_bins = first.shape[0]
    if n_bins > u_cap:
        raise ValueError(f"u_cap {u_cap} below the {n_bins} occupied bins")
    slot = torch.arange(n, device=dev) - first[bin_rank]
    occ_bins = sb[first]  # ascending

    table_ok = slot < K
    dest = torch.where(table_ok, bin_rank * K + slot, u_cap * K)
    far = kernels.far_fill(dtype)
    tables = [
        kernels.scatter_table(dest, cell_list.sorted_positions[d], u_cap * K, far, (u_cap, K))
        for d in range(3)
    ]

    lattice = grid.lattice
    _, dy, dz = grid.dims
    stencil_flat = (_STENCIL[:, 0] * (dy * dz) + _STENCIL[:, 1] * dz + _STENCIL[:, 2]).tolist()
    if lattice <= RANK_TABLE_MAX:
        rank_table = torch.full((lattice,), -1, dtype=torch.int64, device=dev)
        rank_table[occ_bins] = torch.arange(n_bins, device=dev)

    h = compact_support_radius
    acc = torch.zeros((n_bins, K), dtype=dtype, device=dev)
    rows = max(1, _PAIR_BLOCK_ELEMS // (K * K))
    for r0 in range(0, n_bins, rows):
        r1 = min(r0 + rows, n_bins)
        own = [t[r0:r1, :, None] for t in tables]  # (rows, K, 1)
        for delta in stencil_flat:
            target = occ_bins[r0:r1] + delta
            inside = (target >= 0) & (target < lattice)
            if lattice <= RANK_TABLE_MAX:
                nb = rank_table[target.clamp(0, lattice - 1)]
                present = inside & (nb >= 0)
            else:
                nb = torch.searchsorted(occ_bins, target).clamp_max(n_bins - 1)
                present = inside & (occ_bins[nb] == target)
            nb = torch.where(present, nb, 0)
            d2 = None
            for d in range(3):
                diff = own[d] - tables[d][nb][:, None, :]  # (rows, K, K)
                # inf - inf = nan: empty slots must give W = 0
                diff = torch.where(torch.isfinite(diff), diff, math.inf)
                d2 = diff * diff if d2 is None else d2 + diff * diff
            w = kernels.cubic_kernel(torch.sqrt(d2), h).sum(dim=2)
            acc[r0:r1] += torch.where(present[:, None], w, 0.0)

    rho_sorted = torch.where(
        table_ok, acc.reshape(-1)[torch.where(table_ok, bin_rank * K + slot, 0)], 0.0
    )
    rho = torch.empty_like(rho_sorted)
    rho[cell_list.order] = rho_sorted
    if overflow:
        rho = _overflow_correction(
            positions, grid, cell_list, K, candidate_capacity, h, rho
        )
    return kernels.rounded(particle_rest_mass, dtype) * rho


def binned_plan(n: int, lattice: int, n_bins: int, max_occ: int, over8: int) -> dict:
    """The binned formulation's capacities, as the reference picks them:
    K = 8 when no bin holds more ("binned8"); K = 8 with the overflow
    correction when the rank >= 8 particles are few and the lattice is
    small enough for its per-bin tables (also "binned8"); otherwise K = the
    largest occupancy rounded up to 8 ("binned"). ``u_cap`` is the
    occupied-bin count rounded up to a power of two."""
    u_cap = 1 << max(int(n_bins) - 1, 1).bit_length()
    plan = dict(kind="binned8", capacity=8, u_cap=u_cap, overflow=False, ccap=0)
    if max_occ <= 8:
        return plan
    if over8 <= density_over_budget(n) and lattice <= RANK_TABLE_MAX:
        return dict(plan, overflow=True, ccap=_round_up(max_occ + 8))
    return dict(plan, kind="binned", capacity=_round_up(max_occ))


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


def density_gate(n: int, lattice: int, n_bins: int, max_occ: int, over8: int) -> dict:
    """Pick the density formulation from the binning statistics, as the
    reference package does: ``try_geoslot`` (still subject to the octant
    check), ``use_raster`` (with the overflow correction capacity ``ccap``
    when max_occ > 8); otherwise the sparse binned formulation."""
    dense_enough = lattice <= GATE_LATTICE_MAX and n_bins >= lattice // 4
    use_raster = dense_enough and (max_occ <= 8 or over8 <= density_over_budget(n))
    return dict(
        try_geoslot=dense_enough,
        use_raster=use_raster,
        overflow=use_raster and max_occ > 8,
        ccap=_round_up(max_occ + 8) if use_raster and max_occ > 8 else 0,
    )


# The formulation the last compute_particle_densities call took ("geoslot",
# "raster", "binned8" or "binned") and the statistics it was chosen from.
# Read by tests and chip_smoke.py; never by the pipeline.
LAST_GATE: dict = {}


def compute_particle_densities(
    positions: torch.Tensor, compact_support_radius: float, particle_rest_mass: float
) -> torch.Tensor:
    """Per-particle SPH densities (self term included) on the positions'
    device. Plans the bin lattice on the host from a few scalars read back,
    then runs geoslot, else the raster formulation, else the binned one."""
    n = positions.shape[0]
    lo, hi = torch.aminmax(positions, dim=0)
    mn, mx = lo.cpu().numpy(), hi.cpu().numpy()
    grid = BinGrid.for_domain(mn, mx, compact_support_radius)
    cl = build_cell_list(positions, grid)
    max_occ, n_bins, over8 = bin_stats(cl)
    if density_phase_retry(n, over8):
        grid2 = phase_shifted_bingrid(grid, compact_support_radius)
        cl2 = build_cell_list(positions, grid2)
        stats2 = bin_stats(cl2)
        if stats2[2] < over8:
            grid, cl = grid2, cl2
            max_occ, n_bins, over8 = stats2

    gate = density_gate(n, grid.lattice, n_bins, max_occ, over8)
    LAST_GATE.clear()
    LAST_GATE.update(
        n=n, lattice=grid.lattice, n_bins=n_bins, max_occ=max_occ, over8=over8
    )
    if gate["try_geoslot"]:
        phases = _octant_phase(positions, compact_support_radius / 2.0)
        agrid = _phase_aligned_bingrid(mn, mx, compact_support_radius, phases)
        if agrid.lattice <= GATE_LATTICE_MAX:
            rho, ok = compute_particle_densities_geoslot(
                positions, agrid, compact_support_radius, particle_rest_mass
            )
            if bool(ok):
                LAST_GATE["kind"] = "geoslot"
                return rho
        # octant collisions: the sorted formulations below
    if gate["use_raster"]:
        LAST_GATE["kind"] = "raster"
        return compute_particle_densities_raster(
            positions, grid, cl, compact_support_radius, particle_rest_mass,
            slots=8, overflow=gate["overflow"],
            candidate_capacity=gate["ccap"],
        )
    plan = binned_plan(n, grid.lattice, n_bins, max_occ, over8)
    LAST_GATE["kind"] = plan["kind"]
    return compute_particle_densities_binned(
        positions, grid, cl, compact_support_radius, particle_rest_mass,
        capacity=plan["capacity"], u_cap=plan["u_cap"],
        overflow=plan["overflow"], candidate_capacity=plan["ccap"],
    )
