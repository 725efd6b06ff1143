"""grid_read_pct: the share of the window's frames that read their grid
before the frame instead of speculating on the key's grid plan, from the
program's ``plans.GRID_CHECK_STATS``; a program without that counter
leaves the metric unread, and the run goes on."""

import types

import pytest

from bm_small import program, small_run
from harness.files import load_module
from splashsurf_tpu_torch import plans

METRIC = load_module("metrics", "grid_read_pct")


def _window(frames: int, reads: int):
    run = types.SimpleNamespace(frame_ids=list(range(frames)), state={})
    METRIC.before_window(run)
    plans.GRID_CHECK_STATS["read"] += reads
    METRIC.after_window(run)
    return METRIC.read(run)


def test_the_share_of_frames_that_read(monkeypatch):
    monkeypatch.setitem(plans.GRID_CHECK_STATS, "read", 5)
    assert _window(8, 6) == pytest.approx(75.0)
    assert _window(8, 0) == 0.0
    assert _window(0, 0) is None  # no frame completed


def test_a_program_without_the_counter_leaves_it_unread(monkeypatch):
    monkeypatch.delattr(plans, "GRID_CHECK_STATS")
    run = types.SimpleNamespace(frame_ids=[0, 1], state={})
    METRIC.before_window(run)
    METRIC.after_window(run)
    assert METRIC.read(run) is None


@pytest.mark.parametrize("cell, read", [
    ("dam_break_13m.device_flow", True),
    ("dam_break_13m.host_flow", False),  # numpy frames keep no grid plan
])
def test_a_traced_run_reads_it_in_the_tensor_cell(cell, read):
    out = small_run(cell, program, trace=True)
    res = out["result"]
    assert res["correct"], out["check"]
    assert ("grid_read_pct" in res["metrics"]) == read
    if read:
        assert 0 <= res["metrics"]["grid_read_pct"]["value"] <= 100
