"""dam_break: a jittered lattice block of aspect 8:3:2 at spacing 2 r, each
position jittered uniformly by up to a quarter spacing (a copy of the
program's benchmark scene)."""

import torch

from harness.scenes import jitter, lattice


def make(n_target: int, radius: float, gen: torch.Generator, device) -> torch.Tensor:
    spacing = 2.0 * radius
    base = (n_target / (8 * 3 * 2)) ** (1.0 / 3.0)
    nx, ny, nz = int(8 * base), int(3 * base), int(2 * base)
    x, y, z = torch.meshgrid(lattice(nx, spacing, device), lattice(ny, spacing, device),
                             lattice(nz, spacing, device), indexing="ij")
    pts = torch.stack([x, y, z], -1).reshape(-1, 3).to(torch.float32)
    return jitter(pts, spacing, gen)
