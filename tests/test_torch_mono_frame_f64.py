"""The single-dispatch warm frame (``SPLASHSURF_TPU_MONO_FRAME=1``) of the
port against the JAX package's in float64: the nine frames of
``torch_mono.dam_script`` (see ``test_torch_mono_frame.py``, which holds
float32), through the JAX package once and through the port with the
encoded and the packed pull."""

import pytest
import torch

from splashsurf_tpu_torch import frame_graph
import torch_mono as tm
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

DTYPE = "float64"


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
    assert frame_graph.live() == 0
