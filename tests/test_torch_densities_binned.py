"""The binned (sparse-lattice) density formulation of the PyTorch port
against the JAX reference: the gate's choice on sparse clouds, binned8 with
and without the overflow correction, K = the largest occupancy, and the
binary-search neighbour lookup of lattices above 2^24 bins."""

import numpy as np
import pytest
import torch

import bench
from splashsurf_tpu import neighbors as jn

from splashsurf_tpu_torch import neighbors as tn
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

MASS = 1.0
TOL = {
    np.float32: dict(rtol=2e-5, atol=1e-5),
    np.float64: dict(rtol=1e-10, atol=0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_density_plans():
    jn.clear_density_plan()
    yield
    jn.clear_density_plan()


def _uniform(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (2000, 3)), 0.044


def _canyon():
    return bench.make_canyon(3000, 0.05, seed=2), 0.2


def _far_clusters(size=12, seed=4):
    """40 tight clusters spread over a 15-unit box: a lattice above 2^24
    bins, ``size`` particles in some bins."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 15, (40, 1, 3))
    return (centres + rng.uniform(0, 0.03, (40, size, 3))).reshape(-1, 3), 0.044


SCENES = {
    "uniform": (_uniform, "binned8", False),
    "canyon": (_canyon, "binned8", True),
    "far-pairs": (lambda: _far_clusters(size=2), "binned8", False),
    "far-clusters": (_far_clusters, "binned", False),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scene", list(SCENES))
def test_gate_and_densities_match_reference(scene, dtype):
    make, kind, overflow = SCENES[scene]
    pts, support = make()
    pts = pts.astype(dtype)
    want = np.asarray(jn.compute_particle_densities(pts, support, MASS))
    got = tn.compute_particle_densities(torch.as_tensor(pts), support, MASS)
    gate = tn.LAST_GATE
    assert gate["kind"] == kind
    assert not jn.LAST_GATE["single"]["use_raster"]
    assert (gate["max_occ"] > 8) == (overflow or kind == "binned")
    if scene.startswith("far"):
        assert gate["lattice"] > tn.RANK_TABLE_MAX  # the binary-search lookup
    plan = tn.binned_plan(len(pts), gate["lattice"], gate["n_bins"], gate["max_occ"], gate["over8"])
    assert plan["overflow"] == overflow
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_overflow_correction_matches_full_capacity(dtype):
    """binned8 with the overflow correction against the reference's binned
    formulation at K = the largest occupancy, which needs no correction."""
    pts, support = _canyon()
    pts = pts.astype(dtype)
    tpts = torch.as_tensor(pts)
    lo, hi = pts.min(0), pts.max(0)
    grid = tn.BinGrid.for_domain(lo, hi, support)
    cl = tn.build_cell_list(tpts, grid)
    max_occ, n_bins, _ = tn.bin_stats_ex(cl)
    K = tn._round_up(max_occ)
    u_cap = tn.binned_plan(len(pts), grid.lattice, n_bins, max_occ, 0)["u_cap"]
    full = tn.compute_particle_densities_binned(tpts, grid, cl, support, MASS, K, u_cap)
    want = np.asarray(jn.compute_particle_densities(pts, support, MASS, capacity=K))
    np.testing.assert_allclose(full.numpy(), want, **TOL[dtype])
    corrected = tn.compute_particle_densities(tpts, support, MASS)
    assert tn.LAST_GATE["kind"] == "binned8" and tn.LAST_GATE["over8"] > 0
    np.testing.assert_allclose(corrected.numpy(), full.numpy(), **TOL[dtype])


def test_u_cap_is_a_power_of_two():
    for n_bins, u_cap in ((1, 2), (2, 2), (3, 4), (483, 512), (1024, 1024), (1025, 2048)):
        assert tn.binned_plan(10, 100, n_bins, 3, 0)["u_cap"] == u_cap
