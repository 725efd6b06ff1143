"""The roofline metrics' work counts equal a brute-force count on a tiny
scene: every (grid point, particle) pair within the compact support."""


import numpy as np
import torch

from harness import work
from harness.files import load_module
from reference.surface import Params, grid_for


def tiny_scene():
    gen = torch.Generator().manual_seed(3)
    pts = load_module("scenes", "dam_break").make(600, 0.011, gen, "cpu")
    return pts, Params(0.011, 0.044, 0.0165, 0.6, 1000.0)


def test_point_pairs_brute_force():
    pts, p = tiny_scene()
    grid = grid_for(pts, p)
    x = pts.double().numpy()
    axes = [grid.min[d] + np.arange(grid.n_points[d]) * grid.cell_size for d in range(3)]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    d2 = ((pos[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    near = d2 < p.compact_support_radius ** 2
    pairs, points = work.point_pairs(pts, p, elems=5000)
    assert pairs == int(near.sum())
    assert points == int(near.any(1).sum())
    assert 0 < points < len(pos)


def test_block_sizes_do_not_change_counts():
    pts, p = tiny_scene()
    assert len({work.point_pairs(pts, p, elems=e) for e in (216, 3000, 1 << 20)}) == 1
