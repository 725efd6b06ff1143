"""SPH cubic spline kernel (PyTorch port of ``splashsurf_tpu.kernels``).

With compact support radius ``h``, ``q = 2 r / h`` and ``sigma = 8 / h^3``:

    W(r) = sigma * f(q),   f(q) = (1/(4 pi)) * [ (2-q)_+^3 - 4 (1-q)_+^3 ]

(splashsurf_lib/src/kernel.rs:51-141). The clamped-polynomial form needs no
branch, and an empty raster slot (position +inf) evaluates to exactly 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FOUR_PI = 4.0 * math.pi


def far_fill(dtype) -> float:
    """Empty-slot position sentinel: a distance so large that the clamped
    spline is exactly 0. float32 keeps +inf; float64 keeps the finite 1e15
    of the reference package, so that cell arithmetic on both sides agrees
    bit for bit."""
    if np_dtype(dtype) == np.float64:
        return 1.0e15
    return float("inf")


def far_position(dtype) -> float:
    """Dummy-particle position sentinel (finite for both dtypes)."""
    if np_dtype(dtype) == np.float64:
        return 1.0e15
    return 1.0e30


def np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(np.float64 if dtype == torch.float64 else np.float32)
    return np.dtype(dtype)


def rounded(x, dtype) -> float:
    """A host scalar rounded to the precision of ``dtype``: the value a
    dtype-typed constant holds, passed to torch as a Python float."""
    return float(np_dtype(dtype).type(x))


def grid_coord(idx: torch.Tensor, origin: float, spacing: float, dtype) -> torch.Tensor:
    """``origin + idx * spacing`` in ``dtype``, rounded once, as a fused
    multiply-add gives it (the reference package's XLA build fuses this
    expression, and the raster fractions then agree bit for bit). In
    float32 the product and sum are formed in float64, where the product is
    exact, and rounded to float32 once more. float64 goes through
    ``addcmul``, which fuses on the CPU; elsewhere it may round twice."""
    o, s = rounded(origin, dtype), rounded(spacing, dtype)
    if dtype == torch.float32:
        return (o + idx.to(torch.float64) * s).to(torch.float32)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=idx.device)
    return torch.addcmul(scalar(o), idx.to(dtype), scalar(s))


def scatter_table(dest, values, total: int, fill: float, shape) -> torch.Tensor:
    """A ``fill``-valued table of ``total`` entries with ``values`` written
    at ``dest``, reshaped to ``shape``. Index ``total`` is a drop slot (its
    writes are sliced off), so masked entries need no compaction."""
    tbl = torch.full((total + 1,), fill, dtype=values.dtype, device=values.device)
    tbl.index_put_((dest,), values)
    return tbl[:total].reshape(shape)


def cubic_function(q: torch.Tensor) -> torch.Tensor:
    """The normalized cubic spline f(q), support q in [0, 2)."""
    a = torch.clamp_min(2.0 - q, 0.0)
    b = torch.clamp_min(1.0 - q, 0.0)
    return (a * a * a - 4.0 * (b * b * b)) * (1.0 / _FOUR_PI)


def cubic_function_dq(q: torch.Tensor) -> torch.Tensor:
    """Derivative df/dq of the cubic spline."""
    a = torch.clamp_min(2.0 - q, 0.0)
    b = torch.clamp_min(1.0 - q, 0.0)
    return (-3.0 * a * a + 12.0 * (b * b)) * (1.0 / _FOUR_PI)


def _sigma(dtype, compact_support_radius):
    """(h, 8 / h^3) as numpy scalars rounded and combined in ``dtype``'s
    precision, so no device tensor is made per call."""
    h = np_dtype(dtype).type(compact_support_radius)
    return h, h.dtype.type(8.0) / (h * h * h)


def cubic_kernel(r: torch.Tensor, compact_support_radius) -> torch.Tensor:
    """Cubic spline kernel W(r) with compact support radius h (kernel.rs:104-107)."""
    h, sigma = _sigma(r.dtype, compact_support_radius)
    q = (r + r) / float(h)
    return float(sigma) * cubic_function(q)


def cubic_kernel_gradient_norm(r: torch.Tensor, compact_support_radius) -> torch.Tensor:
    """Signed magnitude of the kernel gradient at radius r (kernel.rs:133-140)."""
    h, sigma = _sigma(r.dtype, compact_support_radius)
    q = (r + r) / float(h)
    return float(sigma) * cubic_function_dq(q) * float(h.dtype.type(2.0) / h)
