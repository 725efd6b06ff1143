"""The geoslot hysteresis of the port's density gate against the JAX
package's (``tests/test_density_gate.py``, ``TestGeoslotHysteresis``): the
same call sequence through both packages (three clouds with an octant
collision, the same cloud past the limit, then a cloud without collision)
takes the same formulation at every call on one device, and
``reset_geoslot_hysteresis`` brings geoslot back; plus the counter itself
and ``bin_stats`` / ``bin_stats_ex``. The sharded wrapper's sequence is in
``test_torch_density_gate_sharded.py``."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import neighbors as jn

from splashsurf_tpu_torch import neighbors as tn
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

SUPPORT = 0.1
MASS = 0.37
F32 = dict(rtol=2e-5, atol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv(tn.GEOSLOT_ENV, "1")
    jn.clear_density_plan()
    yield
    jn.clear_density_plan()


def _grid_cloud(side=8, jitter=0.3, seed=0):
    rng = np.random.default_rng(seed)
    coords = (np.arange(side) + 0.5) * SUPPORT
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    return pts + (rng.uniform(-jitter, jitter, pts.shape) * SUPPORT).astype(np.float32)


def _colliding():
    """The grid cloud with two interior neighbours in one octant (the
    geoslot attempt fails); its bounding box, and so every lattice and
    compiled JAX program, is the grid cloud's."""
    pts = _grid_cloud()
    pts[293] = pts[292] + 1e-6
    return pts


def _sequence():
    """(label, cloud): the reference test's three colliding calls, the same
    cloud past the limit, and a cloud without a collision."""
    pts = _colliding()
    lim = jn._GEOSLOT_MAX_CONSECUTIVE_MISSES
    assert lim == tn._GEOSLOT_MAX_CONSECUTIVE_MISSES == 3
    calls = [(f"miss {k}", pts) for k in range(lim)]
    return calls + [("past the limit", pts), ("no collision", _grid_cloud())]


def _reference_single(pts):
    """The JAX package's densities, gate record and formulation (from its
    density plan)."""
    jn.clear_density_plan()
    jn.LAST_GATE.clear()
    rho, _ = jn.compute_particle_densities(pts, SUPPORT, MASS, speculate=True)
    (plan,) = jn._DENSITY_PLAN.values()
    return np.asarray(rho), dict(jn.LAST_GATE["single"]), plan["kind"]


def test_single_device_takes_the_reference_formulation_at_every_call():
    want_kinds = ["raster", "raster", "raster", "raster", "raster"]
    for (label, pts), want in zip(_sequence(), want_kinds):
        jrho, jgate, jkind = _reference_single(pts)
        tn.LAST_GATE.clear()
        trho = tn.compute_particle_densities(torch.as_tensor(pts), SUPPORT, MASS)
        tgate = tn.LAST_GATE["single"]
        assert tgate["try_geoslot"] == jgate["try_geoslot"] == label.startswith("miss"), label
        assert tgate["kind"] == tn.LAST_GATE["kind"] == jkind == want, label
        np.testing.assert_allclose(trho.numpy(), jrho, **F32, err_msg=label)
    assert tn._GEOSLOT_MISSES[0] == jn._GEOSLOT_MISSES[0] == 3
    # a reset restores the attempt, which succeeds on the cloud without collision
    tn.reset_geoslot_hysteresis()
    jn.reset_geoslot_hysteresis()
    jrho, jgate, jkind = _reference_single(_grid_cloud())
    trho = tn.compute_particle_densities(torch.as_tensor(_grid_cloud()), SUPPORT, MASS)
    assert tn.LAST_GATE["single"]["try_geoslot"] and jgate["try_geoslot"]
    assert tn.LAST_GATE["kind"] == jkind == "geoslot"
    np.testing.assert_allclose(trho.numpy(), jrho, **F32)


def test_only_attempts_on_the_lattice_count():
    """An attempt that does not run (geoslot switched off) notes nothing."""
    pts = _colliding()
    for _ in range(4):
        tn.compute_particle_densities(torch.as_tensor(pts), SUPPORT, MASS)
    assert tn._GEOSLOT_MISSES[0] == 3 and not tn._geoslot_wanted()
    tn.reset_geoslot_hysteresis()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tn.GEOSLOT_ENV, "0")
        for _ in range(4):
            tn.compute_particle_densities(torch.as_tensor(pts), SUPPORT, MASS)
    assert tn._GEOSLOT_MISSES[0] == 0 and tn._geoslot_wanted()


def test_success_resets_the_counter():
    tn._note_geoslot_outcome(False)
    tn._note_geoslot_outcome(False)
    assert tn._geoslot_wanted() and tn._GEOSLOT_MISSES[0] == 2
    tn._note_geoslot_outcome(True)
    assert tn._GEOSLOT_MISSES[0] == 0
    for _ in range(3):
        tn._note_geoslot_outcome(False)
    assert not tn._geoslot_wanted()
    assert not tn.density_gate(1000, 1000, 500, 4, 0)["try_geoslot"]
    assert tn.density_gate(1000, 1000, 500, 4, 0)["use_raster"]
    tn.reset_geoslot_hysteresis()
    assert tn.density_gate(1000, 1000, 500, 4, 0)["try_geoslot"]


def test_bin_stats_tuple_shapes_match_the_reference():
    pts = np.concatenate([_grid_cloud(seed=2), np.tile(_grid_cloud(seed=2)[:1], (12, 1))])
    jgrid = jn.BinGrid.for_domain(pts.min(0), pts.max(0), SUPPORT)
    tgrid = tn.BinGrid.for_domain(pts.min(0), pts.max(0), SUPPORT)
    assert tgrid.dims == jgrid.dims
    jcl = jn.build_cell_list(pts, jgrid)
    tcl = tn.build_cell_list(torch.as_tensor(pts), tgrid)
    two, three = tn.bin_stats(tcl), tn.bin_stats_ex(tcl)
    assert len(two) == 2 and len(three) == 3
    assert two == jn.bin_stats(jcl)
    assert three == jn.bin_stats_ex(jcl)
    assert three[0] > 8 and three[2] > 0 and three[:2] == two
