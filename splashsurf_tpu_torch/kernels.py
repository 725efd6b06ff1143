"""SPH cubic spline kernel (PyTorch port of ``splashsurf_tpu.kernels``).

With compact support radius ``h``, ``q = 2 r / h`` and ``sigma = 8 / h^3``:

    W(r) = sigma * f(q),   f(q) = (1/(4 pi)) * [ (2-q)_+^3 - 4 (1-q)_+^3 ]

(splashsurf_lib/src/kernel.rs:51-141). The clamped-polynomial form needs no
branch, and an empty raster slot (position +inf) evaluates to exactly 0.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch.placement import on_device

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
    scalar = lambda v: torch.full((), v, dtype=dtype, device=idx.device)
    return torch.addcmul(scalar(o), idx.to(dtype), scalar(s))


def compact_indices(mask: torch.Tensor, capacity: Optional[int] = None) -> torch.Tensor:
    """Ascending indices of the set entries of the 1-D bool ``mask``.

    Without ``capacity``, all of them (``torch.nonzero``: their count is
    read back from the device). With ``capacity``, a fixed-size list of the
    first ``capacity`` of them, padded with ``mask.numel()``, and nothing is
    read back (``torch.nonzero_static``, which reads nothing back on CUDA
    either)."""
    if capacity is None:
        return torch.nonzero(mask).squeeze(1)
    return torch.nonzero_static(mask, size=capacity, fill_value=mask.numel()).squeeze(1)


def scatter_table(dest, values, total: int, fill: float, shape) -> torch.Tensor:
    """A ``fill``-valued table of ``total`` entries with ``values`` written
    at ``dest``, reshaped to ``shape``. Index ``total`` is a drop slot (its
    writes are sliced off), so masked entries need no compaction."""
    tbl = torch.full((total + 1,), fill, dtype=values.dtype, device=values.device)
    tbl.index_put_((dest,), values)
    return tbl[:total].reshape(shape)


def cubic_function(q, device=None) -> torch.Tensor:
    """The normalized cubic spline f(q), support q in [0, 2)."""
    q = on_device(q, device=device)
    a = torch.clamp_min(2.0 - q, 0.0)
    b = torch.clamp_min(1.0 - q, 0.0)
    return (a * a * a - 4.0 * (b * b * b)) * (1.0 / _FOUR_PI)


def cubic_function_dq(q, device=None) -> torch.Tensor:
    """Derivative df/dq of the cubic spline."""
    q = on_device(q, device=device)
    a = torch.clamp_min(2.0 - q, 0.0)
    b = torch.clamp_min(1.0 - q, 0.0)
    return (-3.0 * a * a + 12.0 * (b * b)) * (1.0 / _FOUR_PI)


def _sigma(dtype, compact_support_radius):
    """(h, 8 / h^3) as numpy scalars rounded and combined in ``dtype``'s
    precision, so no device tensor is made per call."""
    h = np_dtype(dtype).type(compact_support_radius)
    return h, h.dtype.type(8.0) / (h * h * h)


def cubic_kernel(r, compact_support_radius, device=None) -> torch.Tensor:
    """Cubic spline kernel W(r) with compact support radius h (kernel.rs:104-107)."""
    r = on_device(r, device=device)
    h, sigma = _sigma(r.dtype, compact_support_radius)
    q = (r + r) / float(h)
    return float(sigma) * cubic_function(q)


def cubic_kernel_gradient_norm(r, compact_support_radius, device=None) -> torch.Tensor:
    """Signed magnitude of the kernel gradient at radius r (kernel.rs:133-140)."""
    r = on_device(r, device=device)
    h, sigma = _sigma(r.dtype, compact_support_radius)
    q = (r + r) / float(h)
    return float(sigma) * cubic_function_dq(q) * float(h.dtype.type(2.0) / h)


def cubic_kernel_rsq(r_sq, compact_support_radius, device=None) -> torch.Tensor:
    """W evaluated from squared distances."""
    return cubic_kernel(torch.sqrt(on_device(r_sq, device=device)), compact_support_radius)


def cubic_kernel_gradient(dx, compact_support_radius, device=None) -> torch.Tensor:
    """Gradient of W at offsets ``dx``: (..., 3) -> (..., 3)
    (kernel.rs:110-130). The gradient at the origin is zero (the reference
    divides by r and leaves r = 0 to its callers; this guards it)."""
    dx = on_device(dx, device=device)
    h, sigma = _sigma(dx.dtype, compact_support_radius)
    r = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
    drdx = torch.where(r > 0, dx / torch.where(r > 0, r, 1.0), 0.0)
    q = (r + r) / float(h)
    return drdx * (float(sigma) * cubic_function_dq(q) * float(h.dtype.type(2.0) / h))


def cube_particle_volume(particle_radius):
    """Volume of a particle modeled as a cube of fluid: (2r)^3 (kernel.rs:28-30)."""
    return (2.0 * particle_radius) ** 3


def sphere_particle_volume(particle_radius):
    """Volume of a particle modeled as a sphere of fluid (kernel.rs:33-35)."""
    return (4.0 / 3.0) * math.pi * particle_radius**3


class DiscreteSquaredDistanceCubicKernel:
    """Table kernel over squared distances (kernel.rs:497-545): ``n``
    samples of W at the midpoints of [0, h^2] / n, built in float64 on the
    host and stored in ``dtype``; ``evaluate`` is one gather on the input's
    device, 0 from h^2 on."""

    def __init__(self, n: int, compact_support_radius: float, dtype=np.float32):
        self.n = int(n)
        self.compact_support_radius = float(compact_support_radius)
        h = self.compact_support_radius
        r = np.sqrt((np.arange(self.n, dtype=np.float64) + 0.5) * (h**2 / self.n))
        q = 2.0 * r / h
        a = np.maximum(2.0 - q, 0.0)
        b = np.maximum(1.0 - q, 0.0)
        w = (8.0 / h**3) * (a**3 - 4.0 * b**3) / _FOUR_PI
        self.values = torch.as_tensor(w.astype(np_dtype(dtype)))
        self._scale = self.n / h**2
        self._on_device = {self.values.device: self.values}

    def evaluate(self, r_sq, device=None) -> torch.Tensor:
        r_sq = on_device(r_sq, device=device)
        table = self._on_device.get(r_sq.device)
        if table is None:
            table = self._on_device[r_sq.device] = self.values.to(r_sq.device)
        idx = (r_sq * rounded(self._scale, r_sq.dtype)).to(torch.int64).clamp(0, self.n - 1)
        out = table[idx]
        return torch.where(
            r_sq >= rounded(self.compact_support_radius**2, r_sq.dtype), 0.0, out
        ).to(out.dtype)
