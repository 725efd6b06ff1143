"""The port's device rule: the entry points run on the card unless the
caller asks for the CPU. A tensor input runs on its own device; any other
input goes to ``device=``, by default CUDA, and where CUDA is absent that
raises RuntimeError, never falling back to the CPU."""

from __future__ import annotations

import numpy as np
import torch

from splashsurf_tpu_torch.profiling import profile


def check_device(have: torch.device, device) -> None:
    """ValueError where an explicit ``device`` disagrees with ``have``."""
    if device is None:
        return
    want = torch.device(device)
    if want.type != have.type or (want.index is not None and want.index != have.index):
        raise ValueError(f"tensor on {have} but device={want}")


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the card by default; "
            'pass device="cpu" (or a CPU tensor) to run on the CPU'
        )
    return torch.device("cuda")


def on_device(*xs, device=None):
    """The inputs of one call as tensors on one device: the first tensor's
    among them, else ``device``, by default CUDA (RuntimeError where CUDA is
    absent). A tensor comes back as the very same object (no copy, no
    launch, no read of the card) and None as None; anything else (a numpy
    array, a list, a Python or numpy scalar) goes through ``np.asarray``,
    which keeps its numpy dtype, as ``jnp.asarray`` does under x64. One
    input gives one value, several a tuple."""
    anchor = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if anchor is None:
        target = None if all(x is None for x in xs) else _default_device(device)
    else:
        check_device(anchor.device, device)
        target = anchor.device
    out = tuple(
        x if x is None or isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x), device=target)
        for x in xs
    )
    return out[0] if len(out) == 1 else out


def as_device_tensor(x, device, dtype: torch.dtype) -> torch.Tensor:
    """An entry point's input under ``on_device``'s rule, in ``dtype``: a
    tensor is cast on its own device (the same object where its dtype is
    ``dtype``); an array is cast on the host before its copy, so only
    ``dtype``'s bytes cross to the card, in an "upload" span."""
    if isinstance(x, torch.Tensor):
        check_device(x.device, device)
        return x.to(dtype)
    with profile("upload"):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=_default_device(device))
