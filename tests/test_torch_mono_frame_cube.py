"""The single-dispatch warm frame (``SPLASHSURF_TPU_MONO_FRAME=1``) on a
scene that the JAX package pads, and ``SPLASHSURF_TPU_PREWARM``, against
the JAX package.

A seeded jittered cube of 2,744 particles (r = 0.025), which the JAX
package pads to 3,072 and the port does not: cold, warm and jittered
frames in float32 and float64 hit and miss alike in both packages, with
the same counts, plans (keys without N), densities and meshes.

With ``SPLASHSURF_TPU_PREWARM=1`` a planning frame runs one discarded warm
frame in both packages: the same counts, the key warmed once (not again
after its plans are cleared and made anew), and ``clear_grid_plan`` forgets
it. The port runs it only with the mono frame on: without it the
discarded frame would build nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import splashsurf_tpu as st
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import reconstruction as jr

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import plans
from splashsurf_tpu_torch import reconstruction as tr
import torch_mono as tm
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.025


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_padded_cube_matches_the_reference(dtype, monkeypatch):
    cube = tm.jittered_cube(r=R)
    frames = [cube, cube, cube + np.float32(1e-6)]
    jp, tp = tm.params(dtype, R)
    ref = tm.reference_run(frames, dtype, jp)
    tm.set_switches(monkeypatch, SPLASHSURF_TPU_PULL="encoded")
    got = tm.run_frames("port", frames, dtype, monkeypatch, tp)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert r["hits"] == [k > 0] and r["delta"] == {"frames": 1}, k
        assert g["rho"].shape == (2744,)
        tm.same_frame(g, r, dtype, f"frame {k + 1}")


def test_prewarm_runs_one_discarded_frame_per_planned_key(monkeypatch):
    jp, tp = tm.params("float32")
    f = tm.dam_script()[0][1]
    tm.set_switches(monkeypatch, SPLASHSURF_TPU_PREWARM="1")
    tm.clear_jax_plans()
    jlog, tlog = [], []
    tm.spy(monkeypatch, jgp, jlog)
    tm.spy(monkeypatch, tgp, tlog)
    try:
        for _ in range(2):  # a planning frame, then a warm one
            jb, tb = dict(jgp.SPECULATION_STATS), dict(tgp.SPECULATION_STATS)
            jlog.clear()
            tlog.clear()
            st.reconstruct_surface(jnp.asarray(f), jp)
            pt.reconstruct_surface(torch.as_tensor(f), tp)
            assert tm._delta(tgp.SPECULATION_STATS, tb) == tm._delta(jgp.SPECULATION_STATS, jb)
            assert tlog == jlog
        # planning: the frame's miss, then the discarded frame's hit; warm: a hit
        assert tlog == [True] and len(jr._WARMED) == len(plans.WARMED) == 1
        (gkey,) = plans.WARMED
        assert gkey[0] == len(f) and gkey[1] == "torch.float32"
        # plans cleared but the key warmed: the next planning frame runs none
        tb = dict(tgp.SPECULATION_STATS)
        plans.GRID_PLAN.clear()
        pt.reconstruct_surface(torch.as_tensor(f), tp)
        assert tm._delta(tgp.SPECULATION_STATS, tb) == {"frames": 1}
        jr.clear_grid_plan()
        tr.clear_grid_plan()
        assert not jr._WARMED and not plans.WARMED
    finally:
        tm.clear_jax_plans()


def test_prewarm_off_by_default_in_the_port(monkeypatch):
    """The port's defaults run no discarded frame: ``PREWARM`` defaults to
    "1", as the reference's, but acts only with the mono frame on (not with
    edge-major marching cubes either); "0" turns it off."""
    tp = tm.params("float32")[1]
    f = torch.as_tensor(tm.dam_script()[0][1])
    cases = [
        (dict(SPLASHSURF_TPU_MONO_FRAME=None, SPLASHSURF_TPU_PREWARM=None), 1),
        (dict(SPLASHSURF_TPU_MONO_FRAME=None, SPLASHSURF_TPU_PREWARM="1"), 1),
        (dict(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PREWARM="1",
              SPLASHSURF_TPU_MC="edges"), 1),
        (dict(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PREWARM="0"), 1),
        (dict(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PREWARM=None), 2),
    ]
    for env, frames in cases:
        clear_port_plans()
        with monkeypatch.context() as mp:
            tm.set_switches(mp, **env)
            pt.reconstruct_surface(f, tp)
        assert tgp.SPECULATION_STATS["frames"] == frames, env
        assert len(plans.WARMED) == frames - 1, env


def test_an_error_in_the_discarded_frame_raises(monkeypatch):
    """The discarded frame of a planning frame does not hide an error (on
    the card, a warm frame that cannot be captured): it raises, and its
    key is not warmed."""
    tp = tm.params("float32")[1]
    f = torch.as_tensor(tm.dam_script()[0][1])
    tm.set_switches(monkeypatch, SPLASHSURF_TPU_PREWARM="1")

    def fail(*args, **kwargs):
        raise RuntimeError("the warm frame cannot be captured")

    frame = tgp.reconstruct_surface_global
    calls = []

    def second_fails(*args, **kwargs):
        calls.append(kwargs.get("defer_pull"))
        return (fail if len(calls) > 1 else frame)(*args, **kwargs)

    monkeypatch.setattr(tgp, "reconstruct_surface_global", second_fails)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        pt.reconstruct_surface(f, tp)
    assert calls == [False, True] and not plans.WARMED
