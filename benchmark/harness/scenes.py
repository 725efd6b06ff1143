"""Scenes and their moving frames, made on the device from the seed.

A configuration names its scene (``scene``: the file ``scenes/<scene>.py``,
its ``make`` given ``scene_args``), the particle count it aims at, and the
motion of its fluid (``motion``: the file ``motions/<field>.py``, which
moves axis ``axis`` by ``amplitude_spacings`` particle spacings 2 r); a
traffic mix sets the cycle length F. Frame k of the cycle (k = 0 .. F - 1)
is the base positions moved by the motion field at phase k / F, so the
frames repeat exactly from the seed. The geometry comes from the
configuration's ``scene_seed`` and the seed of the run orders the
particles: every seed does the same work.
"""

from __future__ import annotations

import torch

from harness.files import load_module


def lattice(n: int, spacing: float, device) -> torch.Tensor:
    """``n`` lattice coordinates at ``spacing``, float64."""
    return (torch.arange(n, device=device, dtype=torch.float64) + 0.5) * spacing


def jitter(pts: torch.Tensor, spacing: float, gen: torch.Generator) -> torch.Tensor:
    """Each coordinate moved uniformly by up to a quarter ``spacing``."""
    u = torch.rand(pts.shape, generator=gen, device=pts.device, dtype=torch.float32)
    return pts + (u * 0.5 - 0.25) * spacing


def base_positions(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's scene, (N, 3) float32 on ``device``: its
    geometry from the configuration's own ``scene_seed``, its particles in
    an order drawn from ``seed``. Every seed so gets the same positions,
    hence the same grids, bins and plan sizes, in another order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["scene_seed"]))
    pts = load_module("scenes", cfg["scene"]).make(
        int(cfg["n_particles_target"]), float(cfg["particle_radius"]), gen, device,
        **cfg.get("scene_args", {}))
    gen.manual_seed(int(seed) % (1 << 63))
    return pts[torch.randperm(pts.shape[0], generator=gen, device=device)]


def displacement(base: torch.Tensor, motion: dict, spacing: float, k: int,
                 f: int) -> torch.Tensor:
    """The motion field's displacement of every base position at phase k / f."""
    amp = float(motion["amplitude_spacings"]) * spacing
    d = torch.zeros_like(base)
    if amp != 0.0:
        field = load_module("motions", motion["field"])
        d[:, int(motion["axis"])] = field.along_axis(base, motion, amp, k, f)
    return d


def frames(cfg: dict, traffic: dict, seed: int, device) -> list:
    """The F frames of one cycle, float32 tensors on ``device``."""
    base = base_positions(cfg, seed, device)
    f = int(traffic["cycle_frames"])
    spacing = 2.0 * float(cfg["particle_radius"])
    return [base + displacement(base, cfg["motion"], spacing, k, f) for k in range(f)]
