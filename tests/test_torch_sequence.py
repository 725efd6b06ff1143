"""``reconstruct_sequence`` of the PyTorch port on the CPU, with synthetic
frames (a small dam break, jittered per frame as the reference's sequence
test does): every yielded frame equals a frame-at-a-time run made from the
same speculative plans, the sequence matches the JAX reference's
``reconstruct_sequence``, the deferred mesh pull,
``SPLASHSURF_TPU_PIPELINE=0``, a frame that overflows the raster slots in
the middle of a cell-raster sequence, and the subdomain route."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch import reconstruction as tr
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011
ENV = "SPLASHSURF_TPU_DENSITY_CELLRASTER"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, count=3000, scale=1e-4):
    pts = bench.make_dam_break(count, RADIUS, seed=1)
    return [(pts + np.float32(scale * RADIUS * (k + 1))).astype(np.float32) for k in range(n)]


def _params(**kw):
    return pt.Parameters.new_relative(RADIUS, 4.0, 1.5, **kw)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.mesh.vertices, b.mesh.vertices)
    np.testing.assert_array_equal(a.mesh.triangles, b.mesh.triangles)
    assert torch.equal(a.particle_densities, b.particle_densities)


def _frame_at_a_time(frames, params):
    """Each frame through ``reconstruct_surface`` in turn, from no plan: the
    plans evolve as they do in a sequence without a miss."""
    clear_port_plans()
    return [pt.reconstruct_surface(f, params, device="cpu") for f in frames]


def _recording(frames, log):
    """The frames, noting after each frame's dispatch which density
    formulation it took."""
    for f in frames:
        yield f
        log.append(tn.LAST_GATE.get("kind"))


@pytest.mark.parametrize("env", ["0", "1cpu"])
def test_sequence_equals_frame_at_a_time(env, monkeypatch):
    """Bit for bit on the CPU, with the legacy and the cell-raster densities
    (which, as in the reference, a frame takes once a frame before it has
    planned its grid's MC capacities and left no raster overflow: the
    frames after the first)."""
    monkeypatch.setenv(ENV, env)
    frames, kinds = _frames(3), []
    seq = list(pt.reconstruct_sequence(_recording(frames, kinds), _params(), device="cpu"))
    assert len(seq) == 3
    assert kinds[0] != "cellraster"
    assert (kinds[1:] == ["cellraster"] * 2) == (env == "1cpu")
    for rec, ref in zip(seq, _frame_at_a_time(frames, _params())):
        assert rec.mesh is not None and rec._pending_mesh is None
        assert rec.mesh.num_triangles > 1000
        _assert_same(rec, ref)


def test_matches_reference_sequence():
    """Against the JAX package's own sequence (its deferred pulls and
    plans): equal counts, vertices within 1e-4 (f32, the reference ships t
    quantized to 16 bits)."""
    frames = _frames(3)
    jn.clear_density_plan()
    clear_grid_plan()
    jgs._OVER_PLAN.clear()
    jgs._MC_CAPS.clear()
    try:
        ref = list(st.reconstruct_sequence(frames, st.Parameters.new_relative(RADIUS, 4.0, 1.5)))
    finally:
        jn.clear_density_plan()
        clear_grid_plan()
    seq = list(pt.reconstruct_sequence(frames, _params(), device="cpu"))
    assert len(ref) == len(seq) == 3
    for a, b in zip(seq, ref):
        assert (a.mesh.num_vertices, a.mesh.num_triangles) == (
            b.mesh.num_vertices, b.mesh.num_triangles
        )
        assert np.abs(a.mesh.vertices - np.asarray(b.mesh.vertices)).max() < 1e-4
        np.testing.assert_array_equal(a.mesh.triangles, np.asarray(b.mesh.triangles))


def test_deferred_frame_resolves():
    """A deferred dense frame has no mesh until ``resolve()``; then it
    equals the frame run without deferral."""
    f = _frames(1)[0]
    rec = pt.reconstruct_surface(f, _params(), device="cpu", _defer_pull=True)
    assert rec.mesh is None and rec._pending_mesh is not None
    assert rec.resolve() is rec and rec._pending_mesh is None
    _assert_same(rec, pt.reconstruct_surface(f, _params(), device="cpu"))
    assert rec.resolve().mesh is not None  # resolving twice changes nothing


def test_pipeline_disable_env(monkeypatch):
    """``SPLASHSURF_TPU_PIPELINE=0``: no frame is deferred."""
    deferred = []
    inner = tr.reconstruct_surface

    def spy(*a, _defer_pull=False, **k):
        deferred.append(_defer_pull)
        return inner(*a, _defer_pull=_defer_pull, **k)

    monkeypatch.setattr(tr, "reconstruct_surface", spy)
    frames = _frames(2, count=1500)
    monkeypatch.setenv("SPLASHSURF_TPU_PIPELINE", "0")
    seq = list(pt.reconstruct_sequence(frames, _params(), device="cpu"))
    assert deferred == [False, False]
    assert all(r.mesh.num_triangles > 0 for r in seq)
    monkeypatch.setenv("SPLASHSURF_TPU_PIPELINE", "1")
    for a, b in zip(seq, pt.reconstruct_sequence(frames, _params(), device="cpu")):
        _assert_same(a, b)
    assert deferred[2:] == [True, True]


def test_overflow_burst_mid_sequence_falls_back(monkeypatch):
    """128 coincident particles in frame 2 of a cell-raster sequence: that
    frame overflows the raster slots, takes the legacy densities (its
    bounding box, and so its grid, is new: a planning frame, whose density
    plan misses on the octant collisions) and still equals its
    frame-at-a-time run; its neighbours take the cell-raster path, but for
    frame 0, which plans it."""
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    monkeypatch.setenv(ENV, "1cpu")
    frames = _frames(4)
    burst = frames[2].copy()
    burst[:128] = burst[128]
    frames[2] = burst
    kinds = []
    seq = list(pt.reconstruct_sequence(_recording(frames, kinds), _params(), device="cpu"))
    assert kinds[2] != "cellraster" and kinds[1] == kinds[3] == "cellraster" != kinds[0]
    assert SPECULATION_STATS["density_miss"] == 1
    for rec, want in zip(seq, _frame_at_a_time(frames, _params())):
        _assert_same(rec, want)
    assert pt.check_mesh_consistency(seq[2].mesh.vertices, seq[2].mesh.triangles) is None


def test_subdomain_route_sequence():
    """Frames that take the subdomain route pull their mesh in the stitch:
    the sequence yields them, equal to frame-at-a-time runs."""
    params = _params(grid_decomposition=pt.GridDecompositionParameters(32, auto_disable=False))
    frames = _frames(2, count=1500)
    seq = list(pt.reconstruct_sequence(frames, params, device="cpu"))
    for f, rec in zip(frames, seq):
        assert rec.subdomain_grid is not None and rec.mesh.num_triangles > 0
        _assert_same(rec, pt.reconstruct_surface(f, params, device="cpu"))
