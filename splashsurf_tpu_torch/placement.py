"""The port's device rule: the entry points run on the card unless the
caller asks for the CPU. A tensor input runs on its own device; any other
input goes to ``device=``, by default CUDA, and where CUDA is absent that
raises RuntimeError, never falling back to the CPU."""

from __future__ import annotations

import math

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


# Bytes of one staged chunk of a host array's upload (``chip_smoke.py``
# phase 24 sweeps 4, 16 and 64 MiB on the card).
UPLOAD_CHUNK_BYTES = 16 << 20


def upload_chunks(n_rows: int, row_bytes: int, chunk_bytes: int) -> list:
    """The ``(start, stop)`` row ranges of a staged upload: consecutive,
    each of ``chunk_bytes // row_bytes`` rows (at least one) but the last,
    together every row once."""
    step = max(1, chunk_bytes // max(row_bytes, 1))
    return [(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def _staged_upload(a: np.ndarray, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``a`` in ``dtype`` on ``dev``, copied in chunks of rows through
    staging blocks (pinned, from torch's caching host allocator, where
    ``dev`` is CUDA): each block is filled on the host by torch's parallel
    copy, which also casts, and then copied on the current stream without
    blocking, so the fill of one chunk overlaps the copy of the one before.
    Returns with the copies in flight, after every byte of ``a`` has been
    read. A freed block is handed out again only after its copy has ended
    (the allocator records the stream's use)."""
    src = torch.from_numpy(a)
    dst = torch.empty(src.shape, dtype=dtype, device=dev)
    rows_src, rows_dst = (src, dst) if src.ndim else (src.unsqueeze(0), dst.unsqueeze(0))
    row_bytes = math.prod(rows_dst.shape[1:]) * rows_dst.element_size()
    pin = dev.type == "cuda"
    for i, j in upload_chunks(rows_dst.shape[0], row_bytes, UPLOAD_CHUNK_BYTES):
        stage = torch.empty(rows_dst[i:j].shape, dtype=dtype, pin_memory=pin)
        stage.copy_(rows_src[i:j])
        rows_dst[i:j].copy_(stage, non_blocking=True)
    return dst


def as_device_tensor(x, device, dtype: torch.dtype) -> torch.Tensor:
    """An entry point's input under ``on_device``'s rule, in ``dtype``: a
    tensor is cast on its own device (the same object where its dtype is
    ``dtype``); an array is cast on the host before its copy, so only
    ``dtype``'s bytes cross to the card, in an "upload" span. To a CUDA
    device the copy is staged through pinned chunks and does not
    synchronise the card; the array may be overwritten once this returns."""
    if isinstance(x, torch.Tensor):
        check_device(x.device, device)
        return x.to(dtype)
    with profile("upload"):
        dev = _default_device(device)
        if dev.type != "cuda":
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        return _staged_upload(np.asarray(x), dtype, dev)
