"""Tensor keys whose grid keeps moving read their grid before the frame
(``plans.reads_grid``), on the CPU at a small size.

A key speculates on its grid plan while its grid held on each of its last
``plans.GRID_STILL_FRAMES`` frames; a key whose grid moved within them
reads its grid first, meshes the grid that a miss's redo would mesh, and
counts the frame in ``plans.GRID_CHECK_STATS``. The script: a block of
1,536 particles, cold, then moved by one particle spacing a frame for five
frames, then still for ten."""

import numpy as np
import pytest
import torch

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import plans, profiling
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.011
S = 2 * R  # the particle spacing, larger than a cell (1.5 r)
MOVES, STILL = 5, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    return pt.Parameters.new_relative(R, 4.0, 1.5, iso_surface_threshold=0.6).try_convert(
        "float64")


def _script() -> list:
    """Frame 0, the same block moved by k spacings along x for k = 1..5,
    then frame 5 ten times more."""
    rng = np.random.default_rng(11)
    axes = [(np.arange(n) + 0.5) * S for n in (16, 12, 8)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape) * S
    shifts = list(range(MOVES + 1)) + [MOVES] * STILL
    return [torch.from_numpy(pts + np.array([k * S, 0.0, 0.0])) for k in shifts]


def _run(frame):
    """(SPECULATION_STATS delta, GRID_CHECK_STATS delta, read-backs, mesh)
    of one frame."""
    spec, check = dict(plans.SPECULATION_STATS), dict(plans.GRID_CHECK_STATS)
    reads = profiling.COUNTERS["readbacks"]
    rec = pt.reconstruct_surface(frame, _params())
    return ({k: v - spec[k] for k, v in plans.SPECULATION_STATS.items() if v != spec[k]},
            {k: v - check[k] for k, v in plans.GRID_CHECK_STATS.items() if v != check[k]},
            profiling.COUNTERS["readbacks"] - reads, rec.mesh)


def _same_mesh(mesh, cold, label):
    assert mesh.triangles.shape[0] > 1000, label
    np.testing.assert_array_equal(mesh.triangles, cold.triangles, err_msg=label)
    np.testing.assert_allclose(mesh.vertices, cold.vertices, rtol=0, atol=1e-12, err_msg=label)


@pytest.mark.parametrize("mono", ["0", "1"])
def test_a_moving_key_reads_its_grid_until_it_holds(monkeypatch, mono):
    """Frame at a time, per stage and with the single-dispatch warm frame
    (whose misses count nothing in ``SPECULATION_STATS``, as in the
    reference)."""
    monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", mono)
    frames = _script()
    runs = [_run(f) for f in frames]
    w = plans.GRID_STILL_FRAMES
    # the first move of a still key misses and is redone, as in the
    # reference; every later move is read before the frame
    misses = [k for k, (spec, _, _, _) in enumerate(runs) if spec.get("grid_miss")]
    assert misses == ([1] if mono == "0" else [])
    reads = [k for k, (_, check, _, _) in enumerate(runs) if check.get("read")]
    moved = [k for k, (_, check, _, _) in enumerate(runs) if check.get("moved")]
    assert moved == list(range(2, MOVES + 1))
    assert reads == list(range(2, MOVES + 1 + w))
    assert plans.GRID_CHECK_STATS == {"read": MOVES - 1 + w, "moved": MOVES - 1}
    # a read frame counts what a speculated hit counts: one frame, no miss
    for k in reads:
        assert "grid_miss" not in runs[k][0], k
    # W held frames later the key speculates again: one read-back, the pull
    for k in range(MOVES + 1 + w, len(frames)):
        assert runs[k][0] == {"frames": 1} and runs[k][1] == {} and runs[k][2] == 1, k
    # every mesh is a cold frame's
    for k, f in enumerate(frames):
        plans.clear()
        _same_mesh(runs[k][3], pt.reconstruct_surface(f, _params()).mesh, f"frame {k}")


def test_the_sequence_reads_moving_grids():
    """``reconstruct_sequence`` over the script: each frame is dispatched
    before the one before it resolves, so the first two moves are
    speculated on stale plans and redone at their resolve, and the later
    moves are read. The meshes are the frame-at-a-time ones, and the key
    speculates again by the last frame."""
    frames = _script()
    alone = [pt.reconstruct_surface(f, _params()).mesh for f in frames]
    plans.clear()
    meshes = [rec.mesh for rec in pt.reconstruct_sequence(frames, _params())]
    assert len(meshes) == len(frames)
    for k, (mesh, ref) in enumerate(zip(meshes, alone)):
        _same_mesh(mesh, ref, f"frame {k}")
    assert plans.SPECULATION_STATS["grid_miss"] == 2
    assert plans.GRID_CHECK_STATS["moved"] >= MOVES - 2
    assert plans.GRID_PLAN and not plans.GRID_MOVED


KEY = ("n", "dtype", 1.0, 2.0, 3.0)


def _moved_key():
    plans.GRID_PLAN[KEY] = ("grid", (1, 1, 1))
    plans.note_grid_miss(KEY)
    assert plans.reads_grid(KEY)


@pytest.mark.parametrize("held_before_move", [0, 3, plans.GRID_STILL_FRAMES - 1])
def test_a_move_restarts_the_count_of_held_frames(held_before_move):
    _moved_key()
    plan = ("grid", (1, 1, 1))
    for _ in range(held_before_move):
        plans.note_grid(KEY, plan, False, read_over=plan)
        assert plans.reads_grid(KEY)
    moved = ("grid", (2, 1, 1))
    assert not plans.note_grid(KEY, moved, False, read_over=plan)  # no planning frame
    for _ in range(plans.GRID_STILL_FRAMES):
        assert plans.reads_grid(KEY)
        plans.note_grid(KEY, moved, False, read_over=moved)
    assert not plans.reads_grid(KEY)
    assert plans.GRID_CHECK_STATS == {
        "read": held_before_move + 1 + plans.GRID_STILL_FRAMES, "moved": 1}


@pytest.mark.parametrize("clear", [plans.clear, plans.clear_grid])
def test_clearing_forgets_the_moves(clear):
    _moved_key()
    plans.note_grid(KEY, ("grid", (1, 1, 1)), False, read_over=("grid", (2, 1, 1)))
    clear()
    assert not plans.reads_grid(KEY) and not plans.GRID_MOVED
    if clear is plans.clear:
        assert plans.GRID_CHECK_STATS == {"read": 0, "moved": 0}
