"""The geoslot hysteresis of the port's sharded density wrapper against the
JAX package's, on 3 virtual CPU shards in both: the call sequence of
``test_torch_density_gate.py`` (three colliding clouds, the same cloud past
the limit, a cloud without collision, then a reset) takes the same
formulation at every call, and the densities agree within the f32 bar."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.parallel.density import compute_particle_densities_sharded as jsharded
from splashsurf_tpu.parallel.mesh import make_mesh as jmake_mesh

from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.parallel import mesh as pm
from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded
from test_torch_density_gate import F32, MASS, SUPPORT, _clean, _grid_cloud, _one_torch_thread, _sequence  # noqa: F401 (fixtures)
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _default_devices():
    yield
    pm.set_devices(None)


def test_sharded_takes_the_reference_formulation_at_every_call(monkeypatch):
    """3 shards in both packages. The reference's sharded wrapper records
    no formulation: its geoslot outcomes are spied on instead."""
    outcomes = []
    note = jn._note_geoslot_outcome
    monkeypatch.setattr(jn, "_note_geoslot_outcome", lambda ok: (outcomes.append(ok), note(ok)))
    jmesh = jmake_mesh(3)
    pm.set_devices(["cpu"] * 3)
    tmesh = pm.make_mesh(device="cpu")
    for label, pts in _sequence() + [("reset", _grid_cloud())]:
        if label == "reset":
            tn.reset_geoslot_hysteresis()
            jn.reset_geoslot_hysteresis()
        outcomes.clear()
        jrho = np.asarray(jsharded(pts, SUPPORT, MASS, mesh=jmesh))
        jgate = dict(jn.LAST_GATE["sharded"])
        jkind = "geoslot" if outcomes and outcomes[-1] else "raster"
        trho = compute_particle_densities_sharded(torch.as_tensor(pts), SUPPORT, MASS, mesh=tmesh)
        tgate = tn.LAST_GATE["sharded"]
        assert tgate["try_geoslot"] == jgate["try_geoslot"], label
        assert tgate["try_geoslot"] == (label.startswith("miss") or label == "reset"), label
        assert tgate["kind"] == jkind == ("geoslot" if label == "reset" else "raster"), label
        np.testing.assert_allclose(trho.numpy(), jrho, **F32, err_msg=label)
    assert tn._GEOSLOT_MISSES[0] == jn._GEOSLOT_MISSES[0] == 0
