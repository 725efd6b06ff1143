"""canyon: a sheet of ``layers`` particle layers at spacing 2 r over
rolling terrain (two incommensurate waves of amplitude far above the
sheet's depth), horizontal extent 4:1, jittered by up to a quarter spacing
(a copy of the program's benchmark scene)."""

import torch

from harness.scenes import jitter, lattice


def make(n_target: int, radius: float, gen: torch.Generator, device,
         layers: int = 8) -> torch.Tensor:
    spacing = 2.0 * radius
    base = (n_target / (4 * layers)) ** 0.5
    nx, nz = int(4 * base), int(base)
    x, z = torch.meshgrid(lattice(nx, spacing, device), lattice(nz, spacing, device),
                          indexing="ij")
    terrain = 0.9 * (torch.sin(x * 1.7) * torch.cos(z * 2.3) + 0.6 * torch.sin(x * 0.4 + z))
    sheets = [torch.stack([x, terrain + (layer + 0.5) * spacing, z], -1).reshape(-1, 3)
              for layer in range(layers)]
    pts = torch.cat(sheets).to(torch.float32)
    return jitter(pts, spacing, gen)
