"""The single-dispatch warm frame (``SPLASHSURF_TPU_MONO_FRAME=1``) of the
port against the JAX package's, in float32 (``_f64`` holds float64, ``_cube``
a padded scene and ``SPLASHSURF_TPU_PREWARM``).

The nine frames of ``torch_mono.dam_script`` go through the JAX package
once (a module fixture) and through the port twice: with the encoded pull,
the reference's mono frame's, and with the port's default, the packed
pull. Frame by frame both packages' mono frames hit or miss alike, move
``SPECULATION_STATS`` alike, leave the same plans (the pull plans compared
where both pulls are encoded) and give the same densities and mesh.

On its own, the port's mono frame gives the mesh and densities of its
per-stage warm frame on the same plans bit for bit (packed pull); the
graph key holds every static argument of the reference's ``_warm_frame``;
and with the switch unset, or with edge-major marching cubes, the mono
frame is not taken.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

import splashsurf_tpu.global_pipeline as jgp

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import frame_graph
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import neighbors as tn
import torch_mono as tm
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

DTYPE = "float32"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    return tm.reference_run([f for _, f, _, _ in tm.dam_script()], DTYPE, tm.params(DTYPE)[0])


@pytest.mark.parametrize("pull", ["encoded", "packed"])
def test_scripted_frames_match_the_reference(reference, pull, monkeypatch):
    tm.set_switches(monkeypatch, SPLASHSURF_TPU_PULL=pull)
    script = tm.dam_script()
    got = tm.run_frames("port", [f for _, f, _, _ in script], DTYPE, monkeypatch,
                        tm.params(DTYPE)[1])
    for (label, _, outcome, reasons), g, ref in zip(script, got, reference):
        assert ref["hits"] == outcome, f"the reference's {label}"
        assert g["reasons"] == reasons, label
        assert ref["delta"] == {"frames": len(outcome)}, f"the reference's {label}"
        tm.same_frame(g, ref, DTYPE, f"{label} ({pull})", pull_plans=pull == "encoded")
    assert frame_graph.live() == 0  # the CPU runs the frame eagerly


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mono_frame_is_the_per_stage_warm_frame(dtype, monkeypatch):
    """A warm frame on the plans of a cold one: the mono frame's mesh and
    densities equal the per-stage frame's bit for bit (packed pull)."""
    tm.set_switches(monkeypatch, SPLASHSURF_TPU_PULL="packed")
    tp = tm.params(dtype)[1]
    f = tm.dam_script()[0][1].astype(dtype)
    recs = {}
    for mono in ("0", "1"):
        monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", mono)
        clear_port_plans()
        pt.reconstruct_surface(torch.as_tensor(f), tp)
        log = []
        with monkeypatch.context() as mp:
            tm.spy(mp, tgp, log)
            recs[mono] = pt.reconstruct_surface(torch.as_tensor(f + 1e-6), tp)
        assert log == [mono == "1"]
    a, b = recs["0"], recs["1"]
    np.testing.assert_array_equal(b.mesh.triangles, a.mesh.triangles)
    np.testing.assert_array_equal(b.mesh.vertices, a.mesh.vertices)
    assert torch.equal(b.particle_densities, a.particle_densities)
    assert tn.LAST_GATE["kind"] == "geoslot"


def test_the_mono_frame_is_off_by_default_and_on_edge_major_mc(monkeypatch):
    """Unset, the switch takes no mono frame (the per-stage path runs as
    before); with ``SPLASHSURF_TPU_MC=edges`` neither does "1", as the
    reference's mono frame is cell-major only."""
    tp = tm.params(DTYPE)[1]
    f = torch.as_tensor(tm.dam_script()[0][1])
    for env in (dict(SPLASHSURF_TPU_MONO_FRAME=None),
                dict(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_MC="edges")):
        clear_port_plans()
        with monkeypatch.context() as mp:
            tm.set_switches(mp, **env)
            log = []
            tm.spy(mp, tgp, log)
            for _ in range(2):
                pt.reconstruct_surface(f, tp)
        assert log == [False, False] and tgp.LAST_WARM["outcome"] == "off", env


def test_the_graph_key_holds_the_reference_static_arguments():
    """Every static argument of the reference's ``_warm_frame`` jit (parsed
    from its decorator, so that a new one fails this test) is a field of the
    port's ``FrameKey``, beside what the port passes to its kernels and ops
    as Python numbers."""
    tree = ast.parse(inspect.getsource(jgp))
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_warm_frame"]
    (static,) = [kw.value for d in fn.decorator_list if isinstance(d, ast.Call)
                 for kw in d.keywords if kw.arg == "static_argnames"]
    names = ast.literal_eval(static)
    assert len(names) == 17 and "grid" in names and "nc_b" in names
    assert set(names) <= set(tgp.FrameKey._fields)
    extra = set(tgp.FrameKey._fields) - set(names)
    assert extra == {"dtype", "n", "device", "mass", "iso", "pull"}
