"""The port's device rule: the entry points run on the card unless the
caller asks for the CPU. A tensor input runs on its own device; any other
input goes to ``device=``, by default CUDA, and where CUDA is absent that
raises RuntimeError, never falling back to the CPU."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def as_device_tensor(x, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor stays on its own device (``device``, if given, must agree);
    anything else becomes a tensor on ``device``, by default CUDA, which
    raises RuntimeError where CUDA is absent."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            want = torch.device(device)
            if want.type != x.device.type or (
                want.index is not None and want.index != x.device.index
            ):
                raise ValueError(f"tensor on {x.device} but device={want}")
        return x if dtype is None else x.to(dtype)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the entry points run on the card by default; "
                'pass device="cpu" (or a CPU tensor) to run on the CPU'
            )
        device = torch.device("cuda")
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
