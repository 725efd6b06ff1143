"""shear: axis ``axis`` moves by A sin(2 pi k / F) (c - lo) / (hi - lo), c
the coordinate along ``by`` and [lo, hi] the base extent along it: a slosh
whose top moves most."""

import math

import torch


def along_axis(base: torch.Tensor, motion: dict, amp: float, k: int, f: int) -> torch.Tensor:
    c = base[:, int(motion["by"])]
    lo, hi = float(c.min()), float(c.max())
    return amp * math.sin(2.0 * math.pi * k / f) * (c - lo) / (hi - lo)
