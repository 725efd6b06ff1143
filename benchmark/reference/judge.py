"""The comparison that decides ``correct``: a frame's outputs as the timed
path produced them (the per-particle densities and the host mesh), held
against the plain reference of ``surface`` worked out again from the same
positions in float64.

The numbers (each is 0 for a perfect answer; ``inf`` where the answer is
malformed: a wrong length, an index out of range, a value not finite):

- ``rho_gap``: the largest relative gap of a particle's density;
- ``ls_gap``: the largest gap between the iso value and the reference level
  set at a mesh vertex, by trilinear interpolation of the reference's grid
  values (on a grid edge that is the edge's own linear interpolation, so
  the number needs no matching of vertices to edges);
- ``count_gap``: the larger relative gap of the vertex and triangle counts;
- ``block_gap``: the vertices counted in blocks of 16^3 cells, the summed
  absolute gap of the block counts over the reference's vertex count, so
  that a patch missing here and one extra there do not cancel;
- ``area_gap``, ``volume_gap``: the relative gaps of the mesh's area and
  signed (divergence theorem) volume.
"""

from __future__ import annotations

import math

import torch

from reference.surface import REFERENCE, Params, SlabPass, densities, grid_for, mesh_totals, \
    slab_mesh

BLOCK_CELLS = 16
# Grid coordinates are pushed this far up before a vertex is put in a block,
# so that a vertex on a block face goes to one side from either mesh.
BLOCK_NUDGE = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def judge(pos: torch.Tensor, p: Params, rho, vertices, triangles, *,
          elems: int = 1 << 24, slab_points: int = 1 << 26) -> dict:
    """The numbers of one frame (``pos``: its positions on the device that
    the reference uses; ``rho``, ``vertices``, ``triangles``: the answer,
    as tensors or arrays). Returns {"numbers": {...}, "info": {...}}."""
    dev = pos.device
    n = pos.shape[0]
    nums = {}
    rho_ref = densities(pos, p, REFERENCE, elems=elems)
    rho = None if rho is None else torch.as_tensor(rho).to(dev, torch.float64)
    if rho is None or tuple(rho.shape) != (n,) or not bool(torch.isfinite(rho).all()):
        nums["rho_gap"] = math.inf
    else:
        nums["rho_gap"] = float(((rho - rho_ref).abs() / rho_ref).max())

    grid = grid_for(pos, p)
    ncx, ncy, ncz = grid.n_cells
    v = torch.as_tensor(vertices).to(dev, torch.float64).reshape(-1, 3)
    t = torch.as_tensor(triangles).to(dev).long().reshape(-1, 3)
    malformed = (not bool(torch.isfinite(v).all()) or v.shape[0] == 0 or t.shape[0] == 0
                 or bool((t < 0).any()) or bool((t >= v.shape[0]).any()))
    gmin = torch.tensor(grid.min, dtype=torch.float64, device=dev)
    g = (v - gmin) / grid.cell_size
    top = torch.tensor(grid.n_cells, device=dev)
    cell = torch.minimum(torch.clamp_min(torch.floor(g).long(), 0), top - 1)
    nblk = [-(-c // BLOCK_CELLS) for c in grid.n_cells]
    nb_t = torch.tensor(nblk, device=dev)

    def block_counts(gv: torch.Tensor) -> torch.Tensor:
        b = torch.minimum(torch.clamp_min(torch.floor((gv + BLOCK_NUDGE) / BLOCK_CELLS).long(),
                                          0), nb_t - 1)
        flat = (b[:, 0] * nblk[1] + b[:, 1]) * nblk[2] + b[:, 2]
        return torch.bincount(flat, minlength=nblk[0] * nblk[1] * nblk[2])

    ref_blocks = torch.zeros(nblk[0] * nblk[1] * nblk[2], dtype=torch.long, device=dev)
    tot = {"v": 0, "t": 0, "area": 0.0, "volume": 0.0, "resid": 0.0}
    order = torch.argsort(cell[:, 0])
    cx_sorted = cell[order, 0].contiguous()

    def visit(vals, px0, own1):
        m = slab_mesh(vals, px0, own1, grid, p.iso, REFERENCE)
        tot["v"] += m.keys.shape[0]
        tot["t"] += m.n_tris
        tot["area"] += m.area
        tot["volume"] += m.volume
        ref_blocks.add_(block_counts((m.verts - gmin) / grid.cell_size))
        lo = int(torch.searchsorted(cx_sorted, torch.tensor(px0, device=dev)))
        hi = int(torch.searchsorted(cx_sorted, torch.tensor(min(own1, ncx), device=dev)))
        if hi > lo and not malformed:
            idx = order[lo:hi]
            c = cell[idx]
            f = g[idx] - c
            c = c - torch.tensor([px0, 0, 0], device=dev)
            phi = torch.zeros(idx.shape[0], dtype=torch.float64, device=dev)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                             * (f[:, 2] if dz else 1 - f[:, 2]))
                        phi += w * vals[c[:, 0] + dx, c[:, 1] + dy, c[:, 2] + dz].double()
            tot["resid"] = max(tot["resid"], float((phi - p.iso).abs().max()))

    SlabPass(pos, p.mass / rho_ref, grid, p, REFERENCE, elems=elems,
             slab_points=slab_points).run(visit)
    info = {"ref_vertices": tot["v"], "ref_triangles": tot["t"], "vertices": int(v.shape[0]),
            "triangles": int(t.shape[0]), "grid": list(grid.n_cells)}
    if malformed:
        for k in ("ls_gap", "count_gap", "block_gap", "area_gap", "volume_gap"):
            nums[k] = math.inf
        return {"numbers": nums, "info": info}
    area, volume = mesh_totals(v, t)
    nums["ls_gap"] = tot["resid"]
    nums["count_gap"] = max(_rel(v.shape[0], tot["v"]), _rel(t.shape[0], tot["t"]))
    nums["block_gap"] = float((block_counts(g) - ref_blocks).abs().sum()) / max(1, tot["v"])
    nums["area_gap"] = _rel(area, tot["area"])
    nums["volume_gap"] = _rel(volume, tot["volume"])
    info.update(ref_area=tot["area"], ref_volume=tot["volume"], area=area, volume=volume)
    return {"numbers": nums, "info": info}
