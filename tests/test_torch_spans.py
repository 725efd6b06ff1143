"""The port's spans and its read-back counter (``splashsurf_tpu_torch.
profiling``) on the dense route, on the CPU at a small size.

``profile`` is the span: under ``torch.profiler`` it lands in the trace as
a host event of its name; with the recorder on (``record_spans``)
it adds to ``span_totals`` the spans that no span of its name encloses
(device seconds are host seconds on the CPU); off, it makes neither.
Attempts that a plan miss repeats run inside "redo <plan>". Every read of
the card on the dense route goes through ``read_back`` and counts in
``COUNTERS["readbacks"]``: nine on a planning frame that takes the geoslot
densities, one on a tensor frame on its plans, two on a host frame on its
plans (PERF.md, section 3)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline, neighbors, profiling
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.011
S = 2 * R  # the lattice spacing
STAGES = ("grid", "compute particle densities", "dense raster", "dense level set", "dense mc",
          "mesh pull", "read back")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.record_spans(False)
    yield
    profiling.record_spans(False)


def _block() -> np.ndarray:
    """A jittered lattice block of 16 x 8 x 8 particles, spacing 2r."""
    rng = np.random.default_rng(7)
    axes = [(np.arange(n) + 0.5) * S for n in (16, 8, 8)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return (pts + rng.uniform(-0.05, 0.05, pts.shape) * S).astype(np.float32)


def _params():
    return pt.Parameters.new_relative(R, 4.0, 1.5, iso_surface_threshold=0.6)


def _frame(x):
    """One frame: a tensor runs on its own device, an array on the CPU."""
    return pt.reconstruct_surface(x, _params(), device=None if torch.is_tensor(x) else "cpu")


def _traced(frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for x in frames:
            _frame(x)
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("route, switch, extra", [
    ("tensor", None, ()),
    ("host", None, ("upload",)),
    ("cellraster", ("SPLASHSURF_TPU_DENSITY_CELLRASTER", "1cpu"), ("cellraster densities",)),
    ("mono", ("SPLASHSURF_TPU_MONO_FRAME", "1"), ("warm frame",)),
])
def test_stage_spans_in_the_trace_inside_frame(monkeypatch, route, switch, extra):
    if switch is not None:
        monkeypatch.setenv(*switch)
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "0")
    x = _block()
    frames = [x, x] if route == "host" else [torch.from_numpy(x)] * 2
    events = _traced(frames)
    frames_at = [(s, e) for name, s, e in events if name == "frame"]
    assert len(frames_at) == 2
    names = {name for name, _, _ in events}
    for stage in STAGES + extra:
        assert stage in names, (stage, sorted(names))
    for name, s, e in events:
        if name in STAGES + extra:
            assert any(fs <= s and e <= fe for fs, fe in frames_at), name


def test_plan_misses_redo_inside_redo_spans():
    profiling.record_spans(True)
    x = _block()
    # host frames keep no grid plan: a move past the density plan's lattice
    # redoes the frame's density pass
    _frame(x)
    _frame(x + np.float32([4 * S, 0, 0]))
    t = profiling.span_totals()
    assert t["redo density"]["count"] == 1 and "redo grid" not in t
    assert global_pipeline.SPECULATION_STATS["density_miss"] == 1
    # tensor frames: a move past the grid plan's bounds redoes the frame's
    # attempt; the redo's density pass (the move broke that plan too) is
    # inside it and counts once in the group
    clear_port_plans()
    profiling.record_spans(True)
    _frame(torch.from_numpy(x))
    _frame(torch.from_numpy(x + np.float32([0, 3 * S, 0])))
    t = profiling.span_totals()
    assert t["redo grid"]["count"] == 1 and t["redo density"]["count"] == 1
    assert t[profiling.REDO]["count"] == 1
    assert t[profiling.REDO]["device_s"] == t["redo grid"]["device_s"]
    assert t["redo grid"]["device_s"] < t["frame"]["device_s"]
    assert t["frame"]["count"] == 2
    assert global_pipeline.SPECULATION_STATS["grid_miss"] == 1


def test_deferred_redo_span(monkeypatch):
    profiling.record_spans(True)
    x = _block()
    frames = [torch.from_numpy(x), torch.from_numpy(x + np.float32([0, 3 * S, 0]))]
    meshes = list(pt.reconstruct_sequence(frames, _params()))
    assert all(m.mesh is not None for m in meshes)
    t = profiling.span_totals()
    assert t["redo deferred"]["count"] == 1 and t[profiling.REDO]["count"] == 1
    # the rerun is a frame of its own, at the resolve, inside "redo deferred"
    assert t["frame"]["count"] == 3


def test_off_spans_make_no_annotation_and_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span off made an annotation or an event")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = profiling.COUNTERS["readbacks"]
    rec = _frame(torch.from_numpy(_block()))
    assert len(rec.mesh.triangles) > 0
    assert profiling.COUNTERS["readbacks"] > before  # the counter is always on
    profiling.record_spans(True)  # on the CPU the recorder makes no event either
    _frame(torch.from_numpy(_block()))
    assert profiling.span_totals()["frame"]["count"] == 1


def test_recorder_counts_outermost_spans_with_host_seconds():
    profiling.record_spans(True, "cpu")
    with profiling.profile("a"):
        with profiling.profile("a"):
            with profiling.profile("b"):
                pass
        with profiling.profile("redo x"):
            with profiling.profile("redo y"):
                pass
    with profiling.profile("b"):
        pass
    t = profiling.span_totals()
    assert {k: v["count"] for k, v in t.items()} == {
        "a": 1, "b": 2, "redo x": 1, "redo y": 1, profiling.REDO: 1}
    assert all(v["device_s"] == v["host_s"] for v in t.values())
    assert t[profiling.REDO]["host_s"] == t["redo x"]["host_s"]
    assert t["a"]["host_s"] >= t["redo x"]["host_s"] >= t["redo y"]["host_s"]
    profiling.record_spans(False)
    assert profiling.span_totals() == t  # the last recording stays readable
    with profiling.profile("a"):
        pass
    assert profiling.span_totals()["a"]["count"] == 1


def test_readbacks_of_a_planning_and_a_planned_frame():
    x = _block()
    counts = []
    for frame in (torch.from_numpy(x), torch.from_numpy(x + np.float32(1e-6)), x, x):
        before = profiling.COUNTERS["readbacks"]
        _frame(frame)
        counts.append(profiling.COUNTERS["readbacks"] - before)
        if len(counts) == 1:
            assert neighbors.LAST_GATE["kind"] == "geoslot"
    # planning frame: the AABB, the density lattice's AABB, the bin
    # statistics, the octant phase, the geoslot check, the overflow count,
    # the MC totals, the pull's scalars, the exact pull; a tensor frame on
    # its plans: the pull; a host frame on the plans of its grid (here the
    # tensor frames'): its AABB and the pull
    assert counts == [9, 1, 2, 2]
