"""The end-to-end arithmetic: over a window that holds a stall the rate
takes all the work over all the window's time, so a stall lowers it."""

import types

import pytest

from harness import runner
from harness.stats import rate, spread


def test_throughput_counts_a_stall():
    lat = [0.1] * 19 + [2.0]  # one frame stalls for 2 s
    run = types.SimpleNamespace(frame_ids=list(range(20)), n=[1_000_000] * 20,
                                latencies=lat, window_s=sum(lat))
    got = runner.load_metric("throughput").read(run)
    assert got == pytest.approx(20 / 3.9)
    assert got < 20 / 2.0  # not the best frames' rate
    with pytest.raises(ValueError):
        rate(1, 0)


def test_spread():
    assert spread([1, 1, 1, 1]) == 0
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_peak_less_the_benchmarks_own_bytes():
    run = types.SimpleNamespace(peak_bytes=5_000_000_000, held_bytes=1_000_000_000)
    assert runner.load_metric("peak_device_GB").read(run) == pytest.approx(4.0)
