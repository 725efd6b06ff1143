"""The port's sharded densities (``parallel.density``) on 8 (and 3)
virtual CPU shards, the other cases of ``tests/test_parallel_density.py``:
slot overflow, count-padding dummies, an uneven N, an octant collision and
the hand-over to the single-device wrapper, each against the port's
single-device densities (bit for bit; to tolerance where the overflow
correction runs) and the JAX package's single-device densities; and the
geoslot switch ``SPLASHSURF_TPU_DENSITY_GEOSLOT``, which both packages read
at each call."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import neighbors as jn

from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.parallel import mesh as pm
from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

SUPPORT = 0.1
MASS = 0.37
RTOL = {np.float32: 2e-5, np.float64: 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tn.GEOSLOT_ENV, raising=False)
    jn.clear_density_plan()
    yield
    pm.set_devices(None)


def _mesh(D=8):
    pm.set_devices(["cpu"] * D)
    return pm.make_mesh(device="cpu")


def _grid_cloud(side=14, jitter=0.3, seed=0, dtype=np.float32):
    """About one particle per bin."""
    rng = np.random.default_rng(seed)
    coords = (np.arange(side) + 0.5) * SUPPORT
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(dtype)
    return pts + (rng.uniform(-jitter, jitter, pts.shape) * SUPPORT).astype(dtype)


def _overflow_scene():
    pts = _grid_cloud(side=12, seed=3)
    clump = np.tile(pts[100:101], (20, 1)) + (
        np.random.default_rng(7).uniform(-0.01, 0.01, (20, 3)).astype(np.float32) * SUPPORT
    )
    return np.concatenate([pts, clump]).astype(np.float32)


def _both(pts, mesh, **kw):
    """(sharded, single-device) port densities and the sharded record."""
    t = torch.as_tensor(pts)
    rho_s = compute_particle_densities_sharded(t, SUPPORT, MASS, mesh=mesh, **kw)
    gate = dict(tn.LAST_GATE["sharded"])
    nv = kw.get("n_valid", len(pts))
    rho_1 = tn.compute_particle_densities(t[:nv], SUPPORT, MASS)
    return rho_s.numpy(), rho_1.numpy(), gate


def test_overflow_scene_matches_to_tolerance():
    """Over 8 particles in a bin: the exact overflow correction on the
    slab, whose scatter-add order differs from the single-device pass."""
    pts = _overflow_scene()
    rho_s, rho_1, gate = _both(pts, _mesh())
    assert gate["kind"] == "raster" and gate["overflow"] and gate["max_occ"] > 8
    np.testing.assert_allclose(rho_s, rho_1, rtol=2e-6, atol=0)
    ref = np.asarray(jn.compute_particle_densities(pts, SUPPORT, MASS))
    np.testing.assert_allclose(rho_s, ref, rtol=RTOL[np.float32])


def test_count_padding_dummies():
    """Rows past n_valid shape nothing and come back 0."""
    pts = _grid_cloud(side=10, seed=5)
    n = len(pts)
    ext = np.concatenate([pts, np.full((37, 3), -50.0, np.float32)])
    rho_s, rho_1, gate = _both(ext, _mesh(), n_valid=n)
    assert gate["n"] == n
    np.testing.assert_array_equal(rho_s[:n], rho_1)
    assert rho_s.shape == (len(ext),) and np.all(rho_s[n:] == 0.0)
    ref = np.asarray(jn.compute_particle_densities(ext, SUPPORT, MASS, n_valid=n))
    np.testing.assert_allclose(rho_s[:n], ref[:n], rtol=RTOL[np.float32])


@pytest.mark.parametrize("D", [8, 3])
def test_uneven_particle_count(D):
    pts = _grid_cloud(side=9, seed=11)[:-3]
    rho_s, rho_1, _ = _both(pts, _mesh(D))
    assert rho_s.shape == (len(pts),)
    np.testing.assert_array_equal(rho_s, rho_1)
    ref = np.asarray(jn.compute_particle_densities(pts, SUPPORT, MASS))
    np.testing.assert_allclose(rho_s, ref, rtol=RTOL[np.float32])


def test_collision_falls_back_in_both_wrappers():
    pts = _grid_cloud()
    pts[1] = pts[0] + 1e-6  # an octant collision
    rho_s, rho_1, gate = _both(pts, _mesh())
    assert gate["try_geoslot"] and gate["kind"] == "raster"
    assert tn.LAST_GATE["single"]["kind"] == "raster"
    np.testing.assert_array_equal(rho_s, rho_1)


def test_sparse_lattice_and_one_device_hand_over_to_the_single_device_wrapper():
    pts = _grid_cloud(side=6, seed=4) * np.float32([30.0, 1.0, 1.0])  # a sparse lattice
    rho_s, rho_1, gate = _both(pts, _mesh())
    assert gate["kind"] == "replicated" and not gate["use_raster"]
    assert tn.LAST_GATE["kind"] in ("binned8", "binned")
    np.testing.assert_array_equal(rho_s, rho_1)
    pm.set_devices(None)
    rho_d1, rho_1, gate = _both(_grid_cloud(side=6), pm.make_mesh(device="cpu"))
    assert gate == dict(kind="replicated", reason="one device")
    np.testing.assert_array_equal(rho_d1, rho_1)


@pytest.mark.parametrize("switch, want", [("0", "raster"), ("1", "geoslot")])
def test_geoslot_switch_gives_both_packages_one_formulation(monkeypatch, switch, want):
    """``SPLASHSURF_TPU_DENSITY_GEOSLOT``, read at each call: "0" skips the
    geoslot attempt in both packages' single-device wrappers and in the
    gate the sharded wrappers share. The scene is the uneven case's, whose
    JAX program is then compiled already."""
    pts = _grid_cloud(side=9, seed=11)[:-3]
    monkeypatch.setenv(tn.GEOSLOT_ENV, switch)
    jn.compute_particle_densities(pts, SUPPORT, MASS, speculate=True)
    (plan,) = jn._DENSITY_PLAN.values()
    tn.compute_particle_densities(torch.as_tensor(pts), SUPPORT, MASS)
    assert plan["kind"] == tn.LAST_GATE["single"]["kind"] == tn.LAST_GATE["kind"] == want
    assert jn.LAST_GATE["single"]["try_geoslot"] == tn.LAST_GATE["single"]["try_geoslot"]
    compute_particle_densities_sharded(torch.as_tensor(pts), SUPPORT, MASS, mesh=_mesh())
    stats = {k: tn.LAST_GATE["sharded"][k] for k in ("lattice", "n_bins", "max_occ", "over8")}
    assert tn.LAST_GATE["sharded"]["kind"] == want
    ref = jn.density_gate(len(pts), which="sharded", **stats)
    assert ref["try_geoslot"] == tn.LAST_GATE["sharded"]["try_geoslot"] == (switch == "1")
