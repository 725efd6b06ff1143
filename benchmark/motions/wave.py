"""wave: axis ``axis`` moves by A sin(2 pi (c / wavelength - k / F)), c the
coordinate along ``along``: a wave travelling along it."""

import math

import torch


def along_axis(base: torch.Tensor, motion: dict, amp: float, k: int, f: int) -> torch.Tensor:
    c = base[:, int(motion["along"])].double()
    phase = 2.0 * math.pi * (c / float(motion["wavelength"]) - k / f)
    return (amp * torch.sin(phase)).to(base.dtype)
