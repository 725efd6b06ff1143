"""The work a frame needs, counted from its positions with plain PyTorch,
whatever code computes it: the (grid point, particle) pairs within the
compact support that the level set must sum, and the grid points it must
write. The roofline metrics turn these counts into operations and bytes."""

from __future__ import annotations

import math

import torch

from reference.surface import Params, grid_for


def point_pairs(pos: torch.Tensor, p: Params, elems: int = 1 << 24) -> tuple:
    """(pairs, points): the (grid point, particle) pairs closer than the
    compact support on the background grid of these positions, and the
    grid points that at least one particle reaches: the terms of the level
    set's sums and the values it must write."""
    x = pos.to(torch.float64)
    grid = grid_for(pos, p)
    cs, h = grid.cell_size, p.compact_support_radius
    rs = h / cs
    m = int(math.floor(2.0 * rs)) + 1
    gmin = torch.tensor(grid.min, dtype=torch.float64, device=x.device)
    base = torch.ceil((x - gmin) / cs - rs).long()
    r = torch.arange(m, device=x.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    npx, npy, npz = grid.n_points
    top = torch.tensor(grid.n_points, device=x.device)
    reached = torch.zeros(npx * npy * npz, dtype=torch.bool, device=x.device)
    block = max(1, elems // offs.shape[0])
    pairs = 0
    for s in range(0, x.shape[0], block):
        e = min(x.shape[0], s + block)
        pts = base[s:e, None, :] + offs[None]
        d2 = (((gmin + pts.to(torch.float64) * cs) - x[s:e, None, :]) ** 2).sum(-1)
        ok = (d2 < h * h) & (pts >= 0).all(-1) & (pts < top).all(-1)
        pairs += int(ok.sum())
        q = pts[ok]
        reached[(q[:, 0] * npy + q[:, 1]) * npz + q[:, 2]] = True
    return pairs, int(reached.sum())
