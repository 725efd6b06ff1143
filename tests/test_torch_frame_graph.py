"""The bound on the mono frame's CUDA graphs (``frame_graph``): at most one
live graph per card, whatever the slot.

The capture and the replay are stubbed (a CUDA graph needs the card), so
these tests hold the bookkeeping of ``frame_graph.run`` and ``drop`` on
the CPU: frames on moved grid origins and on two particle counts keep one
graph live, a repeated (slot, key) replays, and the graph a capture
replaces is gone before the capture's eager run begins. The last test
holds, through the whole pipeline on the CPU, that numpy frames on moved
grid origins still take the mono frame, with the per-stage frame's mesh
and densities bit for bit.
"""

import weakref

import numpy as np
import pytest
import torch

import bench
import chip_smoke
import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import frame_graph
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch.reconstruction import _bucket_grid
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.011
PARAMS = pt.Parameters.new_relative(R, 4.0, 1.5)


class _Calls(list):
    """The stubs' calls, and weak references to the graphs that the next
    capture replaces (``_run`` notes them)."""

    def __init__(self):
        super().__init__()
        self.replaced = []


@pytest.fixture
def stubbed(monkeypatch):
    """``_FrameGraph.capture`` and ``replay`` replaced by stubs; yields the
    list of calls: ("capture", key, the graphs live as its eager run
    begins, whether each graph it replaces is dead by then) and ("replay",
    key)."""
    calls = _Calls()
    replaced = calls.replaced

    def capture(self, fn, positions):
        live = list(frame_graph._GRAPHS.values())
        calls.append(("capture", self.key, live, [r() is None for r in replaced]))
        replaced.clear()
        self.graph, self.input = "graph", positions
        self.out = fn(positions)  # the eager run
        return self.out

    def replay(self, positions):
        calls.append(("replay", self.key))
        return self.out

    monkeypatch.setattr(frame_graph._FrameGraph, "capture", capture)
    monkeypatch.setattr(frame_graph._FrameGraph, "replay", replay)
    frame_graph.drop()
    yield calls
    frame_graph.drop()


def _slot(positions: torch.Tensor):
    """The slot that ``global_pipeline._try_warm_frame`` gives these
    positions: their bucketed grid, N, dtype and device."""
    grid = _bucket_grid(pt.grid_for_reconstruction(
        positions, PARAMS.particle_radius, PARAMS.compact_support_radius, PARAMS.cube_size))
    return (grid, positions.shape[0], str(positions.dtype), str(positions.device))


def _frames(n: int = 600) -> list:
    """A dam break and the frames of ``chip_smoke.py`` phase 20 (f): the
    same scene on six grid origins, one cell apart."""
    base, moved = chip_smoke.moved_origin_frames(pt, bench.make_dam_break(n, R, seed=3), PARAMS)
    return [base] + moved


def _run(slot, key, positions, replaced=None):
    """``frame_graph.run`` of a frame function that returns its input; with
    ``replaced``, first note weak references to the graphs live now."""
    if replaced is not None:
        replaced.extend(weakref.ref(g) for g in frame_graph._GRAPHS.values())
    return frame_graph.run(slot, key, lambda p: (p,), positions)


def test_moved_origins_and_counts_keep_one_graph(stubbed):
    """Seven grid origins and then a smaller N: each a new slot, each a
    capture, one graph live after each."""
    frames = [torch.as_tensor(f) for f in _frames()]
    slots = [_slot(f) for f in frames]
    assert len({s[0].min for s in slots}) == len(frames)  # a new grid origin each
    assert len({s[0].n_points for s in slots}) == 1
    smaller = frames[0][:-10].contiguous()
    for k, (slot, f) in enumerate(list(zip(slots, frames)) + [(_slot(smaller), smaller)]):
        out = _run(slot, ("key", k), f, stubbed.replaced)
        assert out[0] is f
        assert frame_graph.live() == 1, k
        assert list(frame_graph._GRAPHS) == [slot], k
    captures = [c for c in stubbed if c[0] == "capture"]
    assert len(captures) == len(frames) + 1 and not any(c[0] == "replay" for c in stubbed)
    for k, (_, key, live, dead) in enumerate(captures):
        # the graph the capture replaces is dropped, and nothing holds it,
        # before the eager run begins
        assert key == ("key", k) and live == [], k
        assert dead == ([] if k == 0 else [True]), k


def test_a_repeated_slot_and_key_replays(stubbed):
    f = torch.as_tensor(_frames()[0])
    slot = _slot(f)
    _run(slot, "a", f)
    g = frame_graph._GRAPHS[slot]
    for _ in range(3):
        _run(slot, "a", f + 1e-6)
    assert [c[0] for c in stubbed] == ["capture", "replay", "replay", "replay"]
    assert frame_graph._GRAPHS[slot] is g and frame_graph.live() == 1
    # a new key for the slot (a plan set that changed) captures again
    ref = weakref.ref(g)
    del g
    _run(slot, "b", f)
    _, key, live, _ = stubbed[-1]
    assert (key, live) == ("b", []) and ref() is None
    assert frame_graph.live() == 1 and frame_graph._GRAPHS[slot].key == "b"


def test_one_graph_per_card_and_drop(stubbed):
    """Two devices keep a graph each; ``drop(slot)`` drops that slot's
    graph only, ``drop()`` every graph, and a slot with no graph is no
    error."""
    cpu = torch.as_tensor(_frames()[0])
    meta = torch.empty(cpu.shape, device="meta")
    a, b, c = ("cpu", 1), ("meta", 1), ("meta", 2)
    _run(a, "k", cpu)
    _run(b, "k", meta)
    assert frame_graph.live() == 2
    _run(c, "k", meta)  # replaces the meta card's graph, not the CPU's
    assert set(frame_graph._GRAPHS) == {a, c}
    assert stubbed[-1][2] == [frame_graph._GRAPHS[a]]
    frame_graph.drop(("nothing", 0))
    assert frame_graph.live() == 2
    frame_graph.drop(c)
    assert set(frame_graph._GRAPHS) == {a}
    _run(b, "k", meta)
    frame_graph.drop()
    assert frame_graph.live() == 0


def test_numpy_frames_on_moved_origins_take_the_mono_frame(monkeypatch):
    """Numpy frames never speculate the grid, so each moved frame derives a
    grid with a new origin; on the plans of the first frame each still
    takes the mono frame (as the reference compiles once per new static
    grid), with the per-stage frame's mesh and densities bit for bit."""
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "packed")
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "1")
    for name in ("SPLASHSURF_TPU_MC", "SPLASHSURF_TPU_DENSITY_CELLRASTER"):
        monkeypatch.delenv(name, raising=False)
    frames = _frames(3000)
    monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", "1")
    pt.reconstruct_surface(frames[0], PARAMS, device="cpu")  # plans
    assert tgp.LAST_WARM["outcome"] == "no plan"
    for k, f in enumerate(frames[1:], 1):
        state = _plans()
        monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", "1")
        mono = pt.reconstruct_surface(f, PARAMS, device="cpu")
        assert tgp.LAST_WARM["outcome"] == "hit", k
        after = _plans()
        _restore(state)
        monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", "0")
        stage = pt.reconstruct_surface(f, PARAMS, device="cpu")
        assert tgp.LAST_WARM["outcome"] == "off", k
        np.testing.assert_array_equal(mono.mesh.triangles, stage.mesh.triangles, err_msg=str(k))
        np.testing.assert_array_equal(mono.mesh.vertices, stage.mesh.vertices, err_msg=str(k))
        assert torch.equal(mono.particle_densities, stage.particle_densities), k
        assert mono.mesh.triangles.shape[0] > 1000, k
        _restore(after)
    assert frame_graph.live() == 0  # the CPU runs the frame eagerly


def _plan_dicts():
    from splashsurf_tpu_torch import plans

    return (plans.DENSITY_PLAN, plans.GRID_PLAN, plans.OVER_PLAN, plans.MC_CAPS,
            plans.PULL_PLAN, plans.PULL_PLAN_ENC)


def _plans():
    return [dict(d) for d in _plan_dicts()]


def _restore(state):
    for live, saved in zip(_plan_dicts(), state):
        live.clear()
        live.update(saved)


def test_wrappers_count_captured_launches_apart(monkeypatch):
    """A launch queued while the stream is captured counts in
    ``captured``, an eager one in ``launches``."""
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    fn = sk.sweep_global_cuda
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "captured", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    sk._count(fn)
    assert (fn.launches, fn.captured) == (0, 1)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    sk._count(fn)
    assert (fn.launches, fn.captured) == (1, 1)
    assert set(sk.captured_counts()) == {w.__name__ for w in sk.WRAPPERS}
    assert sk.captured_counts()["sweep_global_cuda"] == 1


def test_a_graph_records_the_launches_its_capture_queued(monkeypatch):
    """``_FrameGraph.capture`` with the card's stream and graph calls
    stubbed: the eager run's launches count in ``launches``, the capture's
    in the graph's ``kernels``, which ``frame_graph.kernels()`` reads."""
    import contextlib

    from splashsurf_tpu_torch.ops import splat_kernels as sk

    for w in sk.WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "captured", 0)
    capturing = [False]

    @contextlib.contextmanager
    def graph(_g):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    class Stream:
        def wait_stream(self, _other):
            pass

    monkeypatch.setattr(frame_graph, "_warmup_stream", lambda _dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda _t, _s: None)

    def frame(positions):
        sk._count(sk.occupancy_masks_cuda)
        sk._count(sk.sweep_global_cuda)
        sk._count(sk.density_sweep_cuda)
        return (positions * 2.0,)

    frame_graph.drop()
    try:
        frame_graph.run("slot", "key", frame, torch.zeros(5, 3))
        want = {"occupancy_masks_cuda": 1, "sweep_global_cuda": 1, "density_sweep_cuda": 1}
        assert frame_graph.kernels() == want
        assert frame_graph.kernels(torch.device("cpu")) == want
        assert {w.__name__: w.launches for w in sk.WRAPPERS if w.launches} == want  # eager run
        with pytest.raises(ValueError):
            frame_graph.kernels(torch.device("cuda", 0))
    finally:
        frame_graph.drop()
