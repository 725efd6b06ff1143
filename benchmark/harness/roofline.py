"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit) and the roofline bound of a kernel's work."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS)


def share_pct(bound_seconds: float, kernel_seconds: float):
    """The roofline share in %, or None where no kernel time was traced."""
    if kernel_seconds <= 0:
        return None
    return 100.0 * bound_seconds / kernel_seconds
