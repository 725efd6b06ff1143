"""The arithmetic of the end-to-end metrics and of the spread of runs."""

from __future__ import annotations

import statistics


def rate(total: float, seconds: float) -> float:
    """``total`` over ``seconds``: all the work over all the window's time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return total / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles over the median,
    as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
