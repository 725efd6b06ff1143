"""SPH interpolation of particle quantities to arbitrary points (PyTorch port
of ``splashsurf_tpu.sph_interpolation``; reference:
splashsurf_lib/src/sph_interpolation.rs:14-290).

Particles are sorted into support-sized bins (``neighbors.build_cell_list``);
each query visits the 27 bins around its own, one stencil offset at a time,
and adds that offset's (M,) sums to its accumulators, as the JAX package's
scan does. Queries go in chunks of at most ``CHUNK_ELEMENTS`` candidate
slots, so the (M, K) candidate block of one offset stays within a fixed
budget however many queries there are.

Semantics mirror the reference exactly:
  - normals: normalized SPH gradient of the indicator (density) field,
    sum_j vol_j * (dx/r) * dW/dr  with dx = x_j - x_i (rs:94-121)
  - quantities: sum_j vol_j * W_ij * A_j, optionally Shepard-corrected by
    1 / sum_j vol_j W_ij (rs:205-258)

Positions, volumes and queries live on one device (the densities' when they
are a tensor); results come back as numpy.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.neighbors import (
    _STENCIL,
    BinGrid,
    _round_up,
    _segment_tables,
    bin_stats,
    build_cell_list,
)
from splashsurf_tpu_torch.placement import check_device, on_device

# Candidate slots (queries x bin capacity) of one offset step in one chunk.
CHUNK_ELEMENTS = 1 << 23


class _Bins:
    """The particles' cell list with its per-bin tables and capacity."""

    def __init__(self, positions: torch.Tensor, support: float):
        lo, hi = torch.aminmax(positions, dim=0)
        self.grid = BinGrid.for_domain(lo.cpu().numpy(), hi.cpu().numpy(), support)
        self.cell_list = build_cell_list(positions, self.grid)
        self.capacity = _round_up(bin_stats(self.cell_list)[0])
        self.tables = _segment_tables(self.cell_list.sorted_bins, self.grid.lattice)


def _stencil_scan(points: torch.Tensor, bins: _Bins, step: Callable, init: List[torch.Tensor]):
    """For each chunk of queries and each stencil offset, gather the
    candidates in (M, K) layout and fold ``step(acc, d2, dxs, cand_idx,
    mask, rows)`` into the chunk's accumulators; returns them concatenated
    over the chunks (``init`` gives the accumulators of all queries)."""
    grid, cl = bins.grid, bins.cell_list
    starts_table, counts_table = bins.tables
    dev = points.device
    n = cl.order.shape[0]
    K = bins.capacity
    dims = torch.tensor(grid.dims, device=dev)
    slot = torch.arange(K, device=dev)
    stencil = torch.as_tensor(_STENCIL, device=dev)
    m = points.shape[0]
    chunk = max(1, CHUNK_ELEMENTS // K)
    outs = [[] for _ in init]
    for s in range(0, m, chunk):
        rows = slice(s, min(s + chunk, m))
        q = points[rows]
        acc = [a[rows] for a in init]
        qb = grid.bin_ijk(q)
        for offset in stencil:
            nb = qb + offset
            valid = torch.all((nb >= 0) & (nb < dims), dim=-1)
            nb_flat = grid.flatten(torch.minimum(torch.clamp_min(nb, 0), dims - 1))
            starts = starts_table[nb_flat]
            counts = torch.where(valid, counts_table[nb_flat], 0)
            gpos = torch.clamp(starts[:, None] + slot[None, :], 0, max(n - 1, 0))  # (M, K)
            cand_idx = cl.order[gpos]
            mask = slot[None, :] < counts[:, None]
            dxs = [cl.sorted_positions[d][gpos] - q[:, d][:, None] for d in range(3)]
            d2 = dxs[0] * dxs[0]
            d2 = d2 + dxs[1] * dxs[1]
            d2 = d2 + dxs[2] * dxs[2]
            acc = step(acc, d2, dxs, cand_idx, mask, rows)
        for o, a in zip(outs, acc):
            o.append(a)
    return [torch.cat(o) if o else a for o, a in zip(outs, init)]


class SphInterpolator:
    """Interpolates fluid quantities to arbitrary points (rs:58-74).

    ``particle_densities`` may be a tensor, whose device then holds the
    positions and volumes; otherwise they go to ``device`` (default CUDA,
    raising without it)."""

    def __init__(
        self,
        particle_positions,
        particle_densities,
        particle_rest_mass: float,
        compact_support_radius: float,
        device=None,
    ):
        if isinstance(particle_densities, torch.Tensor):
            device = particle_densities.device
        rho = on_device(particle_densities, device=device)
        self.positions = on_device(particle_positions, device=rho.device).contiguous()
        assert self.positions.shape[0] == rho.shape[0]
        self.volumes = kernels.rounded(particle_rest_mass, rho.dtype) / rho
        self.compact_support_radius = float(compact_support_radius)
        self._bins = _Bins(self.positions, self.compact_support_radius)
        self.grid = self._bins.grid
        self.cell_list = self._bins.cell_list
        self.capacity = self._bins.capacity

    def size(self) -> int:
        return int(self.positions.shape[0])

    def _on_device(self, x, device=None) -> torch.Tensor:
        """Queries or particle values on the particles' device, in their
        own dtype; ``device``, where given, must be that device."""
        check_device(self.positions.device, device)
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return torch.as_tensor(x, device=self.positions.device)

    def _support(self, pts: torch.Tensor) -> float:
        """The support radius in the precision the sums run in: the wider of
        the queries' and the particles' (f32 queries of f64 particles run in
        f64)."""
        return kernels.rounded(
            self.compact_support_radius, torch.promote_types(pts.dtype, self.positions.dtype)
        )

    # -- public API (mirrors SphInterpolator) --------------------------------

    def interpolate_normals(self, points, device=None) -> np.ndarray:
        pts = self._on_device(points, device)
        h = self._support(pts)
        volumes = self.volumes

        def step(acc, d2, dxs, cand_idx, mask, rows):
            # dxs: 3 x (M, K) with dx = x_j - x_i
            r = torch.sqrt(d2)
            safe_r = torch.where(r > 0, r, torch.ones_like(r))
            gnorm = kernels.cubic_kernel_gradient_norm(r, h)
            scale = torch.where(
                mask & (r > 0) & (r < h), gnorm * volumes[cand_idx] / safe_r, 0.0
            )
            return [acc[d] + torch.sum(dxs[d] * scale, dim=1) for d in range(3)]

        init = [pts.new_zeros(pts.shape[0]) for _ in range(3)]
        grad = torch.stack(_stencil_scan(pts, self._bins, step, init), dim=-1)
        norm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
        return (grad / torch.where(norm > 0, norm, torch.ones_like(norm))).cpu().numpy()

    def _quantity(self, quantity: torch.Tensor, points, first_order_correction: bool):
        """(M, D) interpolation of the (N, D) ``quantity``."""
        pts = self._on_device(points)
        h = self._support(pts)
        volumes = self.volumes
        D = quantity.shape[1]
        q_comp = [quantity[:, d] for d in range(D)]

        def step(acc, d2, dxs, cand_idx, mask, rows):
            r = torch.sqrt(d2)
            w = kernels.cubic_kernel(r, h)
            vol_w = torch.where(mask & (r < h), volumes[cand_idx] * w, 0.0)  # (M, K)
            out = [acc[d] + torch.sum(vol_w * q_comp[d][cand_idx], dim=1) for d in range(D)]
            return out + [acc[D] + torch.sum(vol_w, dim=1)]

        init = [pts.new_zeros(pts.shape[0]) for _ in range(D + 1)]
        *accs, corr = _stencil_scan(pts, self._bins, step, init)
        acc = torch.stack(accs, dim=-1)
        if first_order_correction:
            pos = corr > 0
            factor = torch.where(pos, 1.0 / torch.where(pos, corr, torch.ones_like(corr)), 1.0)
            acc = acc * factor[:, None]
        return acc.cpu().numpy()

    def interpolate_scalar_quantity(
        self, particle_quantity, points, first_order_correction: bool = False, device=None
    ) -> np.ndarray:
        q = self._on_device(particle_quantity, device)[:, None]
        return self._quantity(q, points, first_order_correction)[:, 0]

    def interpolate_quantity(
        self, particle_quantity, interpolation_points, *,
        first_order_correction: bool = False,
    ) -> np.ndarray:
        """Interpolate a scalar OR vectorial per-particle quantity
        (pysplashsurf.pyi:205 parity: dispatch on the quantity's rank)."""
        q = np.asarray(particle_quantity)
        if q.ndim <= 1:
            return self.interpolate_scalar_quantity(
                q, interpolation_points,
                first_order_correction=first_order_correction,
            )
        return self.interpolate_vector_quantity(
            q, interpolation_points,
            first_order_correction=first_order_correction,
        )

    def interpolate_vector_quantity(
        self, particle_quantity, points, first_order_correction: bool = False, device=None
    ) -> np.ndarray:
        return self._quantity(
            self._on_device(particle_quantity, device), points, first_order_correction
        )

    def weighted_neighbor_counts(self) -> np.ndarray:
        """``compute_weighted_neighbor_counts`` of the interpolator's own
        particles, on the bins it already holds."""
        return _weighted_neighbor_counts(self.positions, self._bins, self.compact_support_radius)


def compute_weighted_neighbor_counts(
    positions, compact_support_radius: float, device=None
) -> np.ndarray:
    """Distance-weighted neighbor counts, the smoothing-weight ingredient
    (splashsurf/src/reconstruct.rs:1190-1206):
    sum_j (1 - clamp(r^2/R^2, 0, 1)) over neighbors j != i. A tensor runs on
    its own device, an array on ``device`` (default CUDA)."""
    p = on_device(positions, device=device).contiguous()
    return _weighted_neighbor_counts(p, _Bins(p, float(compact_support_radius)), compact_support_radius)


def _weighted_neighbor_counts(p: torch.Tensor, bins: _Bins, compact_support_radius: float) -> np.ndarray:
    h = kernels.np_dtype(p.dtype).type(compact_support_radius)
    r2 = float(h * h)
    self_idx = torch.arange(p.shape[0], device=p.device)

    def step(acc, d2, dxs, cand_idx, mask, rows):
        wc = 1.0 - torch.clamp(d2 / r2, 0.0, 1.0)
        not_self = cand_idx != self_idx[rows][:, None]
        # a neighbor is j with r < support (weight at r >= support is 0 anyway)
        return [acc[0] + torch.sum(torch.where(mask & not_self, wc, 0.0), dim=1)]

    (out,) = _stencil_scan(p, bins, step, [p.new_zeros(p.shape[0])])
    return out.cpu().numpy()


def smooth_step(x):
    """6x^5 - 15x^4 + 10x^3 smooth-step (reconstruct.rs:1227-1233)."""
    x = np.clip(np.asarray(x), 0.0, 1.0)
    return x**3 * (10.0 + x * (-15.0 + 6.0 * x))
