"""The upload of host arrays (``placement.as_device_tensor``): to a CUDA
device the array is staged through pinned chunks of rows and copied without
blocking; to the CPU it goes through ``torch.as_tensor`` as it always has.

Here the chunk planner, the CPU path and the staged walk itself (on the CPU,
unpinned, with small chunks) are checked. On a card (``-m card``; this file
imports no JAX, so ``python -m pytest --noconftest -m card
tests/test_torch_upload.py`` runs it there) the staged upload is held bit for
bit to ``torch.as_tensor(...).to(card)`` on frames of odd row counts whose
source is overwritten as soon as each call returns."""

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch import placement
from splashsurf_tpu_torch.placement import as_device_tensor, upload_chunks

CHUNK = placement.UPLOAD_CHUNK_BYTES
ROW = 12  # one f32 position
STEP = CHUNK // ROW


def _inputs():
    """(name, input, dtype): f32, f64 -> f32, a non-contiguous view, a list,
    odd row counts."""
    rng = np.random.default_rng(7)
    f64 = rng.standard_normal((1001, 3))
    wide = rng.standard_normal((257, 5)).astype(np.float32)
    return [
        ("f32", f64.astype(np.float32), torch.float32),
        ("f64 -> f32", f64, torch.float32),
        ("f64", f64, torch.float64),
        ("non-contiguous", wide[::3, 1:4], torch.float32),
        ("list", f64[:7].tolist(), torch.float32),
    ]


CASES = [name for name, _, _ in _inputs()]


def _case(name):
    """A fresh copy of one input of ``_inputs``, free to overwrite."""
    return next((x, dtype) for n, x, dtype in _inputs() if n == name)


@pytest.mark.parametrize("n", [0, 1, STEP - 1, STEP, STEP + 1, 13_232_700])
def test_chunks_cover_every_row_once(n):
    chunks = upload_chunks(n, ROW, CHUNK)
    covered = [r for i, j in chunks for r in (i, j)]
    assert covered[:1] in ([], [0])
    assert all(a == b for a, b in zip(covered[1:-1:2], covered[2::2]))  # no gap, no overlap
    assert (covered[-1] if chunks else 0) == n
    assert all(0 < (j - i) * ROW <= CHUNK for i, j in chunks)
    assert all(j - i == STEP for i, j in chunks[:-1])


@pytest.mark.parametrize("row_bytes", [0, CHUNK + 1])
def test_chunks_of_rows_without_bytes_or_wider_than_a_chunk(row_bytes):
    assert upload_chunks(3, row_bytes, CHUNK) == ([(0, 3)] if row_bytes == 0 else
                                                 [(0, 1), (1, 2), (2, 3)])


@pytest.mark.parametrize("name", CASES)
def test_cpu_path_is_torch_as_tensor(name):
    x, dtype = _case(name)
    got = as_device_tensor(x, "cpu", dtype)
    want = torch.as_tensor(np.asarray(x), dtype=dtype, device="cpu")
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)
    if isinstance(x, np.ndarray) and x.dtype == np.float32 and x.flags.c_contiguous:
        assert got.data_ptr() == x.ctypes.data  # as before: no copy on the CPU


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("chunk_bytes", [1, 100, CHUNK])
def test_staged_walk_copies_every_row(name, chunk_bytes, monkeypatch):
    """The staged walk on the CPU (no pinning), in chunks of one row, a few
    rows and the default: equal to ``torch.as_tensor``, and a copy that
    keeps its values when the source is overwritten."""
    monkeypatch.setattr(placement, "UPLOAD_CHUNK_BYTES", chunk_bytes)
    x, dtype = _case(name)
    a = np.asarray(x)
    want = torch.as_tensor(a, dtype=dtype).clone()
    got = placement._staged_upload(a, dtype, torch.device("cpu"))
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    a[...] = 0.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("x", [np.float64(2.5), np.zeros((0, 3)), np.arange(5.0)],
                         ids=["scalar", "no rows", "one axis"])
def test_staged_walk_on_odd_shapes(x, monkeypatch):
    monkeypatch.setattr(placement, "UPLOAD_CHUNK_BYTES", 8)
    got = placement._staged_upload(np.asarray(x), torch.float32, torch.device("cpu"))
    assert torch.equal(got, torch.as_tensor(np.asarray(x), dtype=torch.float32))


def test_upload_errors_are_torch_as_tensor_errors():
    bad = np.arange(12.0).reshape(4, 3)[::-1]
    with pytest.raises(ValueError, match="negative"):
        as_device_tensor(bad, "cpu", torch.float32)
    with pytest.raises(ValueError, match="negative"):
        placement._staged_upload(bad, torch.float32, torch.device("cpu"))
    with pytest.raises(TypeError, match="can't convert np.ndarray"):
        placement._staged_upload(np.asarray(["a"]), torch.float32, torch.device("cpu"))


@pytest.mark.card
def test_staged_upload_matches_pageable_copy_on_the_card():
    """Three frames back to back per input, odd row counts over several
    chunks, each source overwritten right after its call: a staging block
    handed out again before its copy ended would show as a wrong row. The
    uploads run under ``set_sync_debug_mode("error")``: none synchronises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n = 3 * STEP + 12_345
    for name, make, dtype in (
        ("f32", lambda: rng.standard_normal((n, 3)).astype(np.float32), torch.float32),
        ("f64 -> f32", lambda: rng.standard_normal((n, 3)), torch.float32),
        ("non-contiguous", lambda: rng.standard_normal((n, 5)).astype(np.float32)[:, 1:4],
         torch.float32),
    ):
        frames = [make() for _ in range(3)]
        wants = [torch.as_tensor(f, dtype=dtype).to(dev) for f in frames]
        gots = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for f in frames:
                gots.append(as_device_tensor(f, dev, dtype))
                f[...] = np.nan
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for k, (got, want) in enumerate(zip(gots, wants)):
            assert got.dtype == dtype and got.device.type == "cuda"
            assert torch.equal(got, want), f"{name} frame {k}"
