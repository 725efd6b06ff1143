"""The per-layer metrics that read the program's spans and its read-back
counter (``harness.spans``): a traced run on the CPU reads all five in
both dam cells, and the stages they name lie inside the frame; a program
without the recorder or the counter leaves them unread, and the run goes
on."""

import pytest

from bm_small import program, small_run
from harness import spans

CELLS = ["dam_break_13m.host_flow", "dam_break_13m.device_flow"]
METRICS = ("densities_ms", "sweep_ms", "mc_ms", "redo_pct", "readbacks_per_frame")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_span_metrics(cell):
    out = small_run(cell, program, trace=True)
    res, run = out["result"], out["run"]
    assert res["correct"], out["check"]
    got = {m: res["metrics"][m]["value"] for m in METRICS}
    assert all(v >= 0 for v in got.values()), got
    assert got["densities_ms"] > 0 and got["sweep_ms"] > 0 and got["mc_ms"] > 0
    assert got["readbacks_per_frame"] >= 1  # every frame reads its mesh back
    frame_ms = spans.device_ms(run, (spans.FRAME,)) / len(run.frame_ids)
    assert got["densities_ms"] + got["sweep_ms"] + got["mc_ms"] <= frame_ms
    assert got["redo_pct"] < 100


def test_a_program_without_spans_leaves_them_unread(monkeypatch):
    import types

    # the profiling module of a program from before the spans: its scope
    # tree and nothing more
    monkeypatch.setattr(spans, "_profiling", lambda: types.SimpleNamespace(profile=None))
    out = small_run(CELLS[0], program, trace=True)
    res = out["result"]
    assert res["correct"], out["check"]
    assert not set(METRICS) & set(res["metrics"])
    assert "plan_miss_pct" in res["metrics"]
