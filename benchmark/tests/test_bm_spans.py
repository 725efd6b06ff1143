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


def test_upload_fill_ms_on_a_span_total():
    import types

    from harness.files import load_module

    m = load_module("metrics", "upload_fill_ms")
    run = types.SimpleNamespace(frame_ids=[0, 1, 2, 3], state={spans.KEY: {"totals": {
        "upload": {"count": 4, "host_s": 0.1, "device_s": 0.2},
        "frame": {"count": 4, "host_s": 0.3, "device_s": 0.4}}}})
    assert m.read(run) == pytest.approx(25.0)  # host seconds, not device seconds
    del run.state[spans.KEY]["totals"]["upload"]
    assert m.read(run) is None  # no upload span: tensors on the card
    run.state = {}
    assert m.read(run) is None  # no recorder


@pytest.mark.parametrize("cell", CELLS)
def test_upload_fill_ms_only_where_frames_are_uploaded(cell):
    out = small_run(cell, program, trace=True)
    res = out["result"]
    assert res["correct"], out["check"]
    if cell.endswith("host_flow"):
        assert res["metrics"]["upload_fill_ms"]["value"] > 0
    else:
        assert "upload_fill_ms" not in res["metrics"]
