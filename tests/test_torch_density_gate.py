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


LATTICE_ENV = "SPLASHSURF_TPU_LATTICE_BUCKET"
LATTICE_H = 0.0131
LATTICE_HI = (1.0, 0.37, 0.23)


@pytest.mark.parametrize("switch, dims", [("0", (79, 31, 20)), ("1", (80, 32, 20))])
def test_lattice_bucket_switch_builds_the_reference_lattice(switch, dims, monkeypatch):
    monkeypatch.setenv(LATTICE_ENV, switch)
    args = ((0.0, 0.0, 0.0), LATTICE_HI, LATTICE_H)
    assert tn.BinGrid.for_domain(*args).dims == jn.BinGrid.for_domain(*args).dims == dims


def _lattice_cloud():
    """A sparse uniform cloud over the domain of the lattice test whose
    occupied bins (12435) lie between a quarter of the unbucketed lattice
    (79 x 31 x 20) and a quarter of the bucketed one (80 x 32 x 20): the
    gate's density test flips with the switch."""
    rng = np.random.default_rng(5)
    hi = np.asarray(LATTICE_HI)
    pts = (rng.uniform(0.0, 1.0, (15_000, 3)) * hi).astype(np.float32)
    pts[0], pts[1] = 0.0, hi.astype(np.float32)
    return pts


@pytest.mark.parametrize("switch, raster", [("0", True), ("1", False)])
def test_lattice_bucket_switch_writes_the_reference_gate(switch, raster, monkeypatch):
    monkeypatch.setenv(LATTICE_ENV, switch)
    pts = _lattice_cloud()
    jn.LAST_GATE.clear()
    jrho = np.asarray(jn.compute_particle_densities(pts, LATTICE_H, MASS))
    tn.LAST_GATE.clear()
    trho = tn.compute_particle_densities(torch.as_tensor(pts), LATTICE_H, MASS)
    jgate, tgate = jn.LAST_GATE["single"], tn.LAST_GATE["single"]
    keys = ("n", "lattice", "n_bins", "max_occ", "over8", "try_geoslot", "use_raster")
    assert {k: tgate[k] for k in keys} == {k: jgate[k] for k in keys}
    assert tgate["use_raster"] == raster
    assert tgate["lattice"] == (79 * 31 * 20 if switch == "0" else 80 * 32 * 20)
    np.testing.assert_allclose(trho.numpy(), jrho, **F32)
