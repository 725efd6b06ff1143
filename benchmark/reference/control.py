"""The control: the reference put in the program's place and computed in
bfloat16, the nearest precision below the configurations' float32.

Positions, distances and grid coordinates stay in float32 (the input's
type); the kernel values, the density and level-set sums and the edge
parameters are bfloat16, as a program that kept its sums in bfloat16
would compute them. It answers a frame as the program does: the
per-particle densities and an indexed host mesh, so that the harness can
judge it in the program's place and see ``correct`` come out false."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference.surface import Params, Precision, SlabPass, densities, grid_for, slab_mesh

BF16 = Precision(torch.float32, torch.bfloat16, torch.float32)


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray
    triangles: np.ndarray


@dataclasses.dataclass
class Answer:
    mesh: Mesh
    particle_densities: torch.Tensor


def reconstruct(positions, p: Params, device, prec: Precision = BF16,
                elems: int = 1 << 24, slab_points: int = 1 << 26) -> Answer:
    """One frame in ``prec``: densities, weights m / rho, the level set and
    marching cubes, the slabs' vertices indexed by their edge keys."""
    pos = torch.as_tensor(positions).to(device, torch.float32)
    rho = densities(pos, p, prec, elems=elems)
    grid = grid_for(pos, p)
    parts = []
    SlabPass(pos, p.mass / rho, grid, p, prec, elems=elems, slab_points=slab_points).run(
        lambda vals, px0, own1: parts.append(
            slab_mesh(vals, px0, own1, grid, p.iso, prec, want_tris=True)))
    keys = torch.cat([m.keys for m in parts])
    verts = torch.cat([m.verts for m in parts])
    tri_keys = torch.cat([m.tri_keys for m in parts if m.tri_keys is not None])
    sk, order = torch.sort(keys)
    pos_in = torch.searchsorted(sk, tri_keys)
    if bool((pos_in >= sk.shape[0]).any()) or not bool((sk[pos_in.clamp_max(
            sk.shape[0] - 1)] == tri_keys).all()):
        raise RuntimeError("a triangle names an edge with no vertex")
    tris = order[pos_in].to(torch.int32)
    return Answer(Mesh(verts.cpu().numpy(), tris.cpu().numpy()), rho.to(torch.float32))
