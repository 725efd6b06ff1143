"""Per-particle SPH densities of the PyTorch port against the JAX reference:
the geoslot formulation on a jittered block, geoslot and the sorted raster
formulation (with its overflow correction) against the brute-force
neighbour oracle, and a sparse cloud through the binned formulation. The
raster formulation against the reference is in
test_torch_densities_raster.py, the binned one in
test_torch_densities_binned.py."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import kernels as jk
from splashsurf_tpu import neighbors as jn

from splashsurf_tpu_torch import neighbors as tn
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011
SUPPORT = 4 * RADIUS
MASS = 1.0
# f32: the same sums in the same order up to the kernels' rounding; f64: roundoff
TOL = {np.float32: dict(rtol=2e-6, atol=0), np.float64: dict(rtol=1e-12, atol=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(spacing_rel, n_side=28, jitter=0.25, seed=3):
    """A jittered lattice block (n x n/2 x n/2) at an arbitrary offset."""
    rng = np.random.default_rng(seed)
    spacing = spacing_rel * RADIUS
    c = (np.arange(n_side) + 0.5) * spacing
    X, Y, Z = np.meshgrid(c, c[: n_side // 2], c[: n_side // 2], indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    pts += rng.uniform(-jitter, jitter, pts.shape) * spacing
    return pts + 0.317


def _oracle(pts):
    """m * (W(0) + sum of W over the neighbours) from the reference's
    O(N^2) neighbour search."""
    p = np.asarray(pts, np.float64)
    nbs = jn.neighborhood_search_naive(p, SUPPORT)
    rows = np.repeat(np.arange(len(p)), [len(nb) for nb in nbs])
    cols = np.concatenate(nbs)
    w = np.asarray(jk.cubic_kernel(np.sqrt(((p[rows] - p[cols]) ** 2).sum(-1)), SUPPORT))
    rho = np.full(len(p), float(jk.cubic_kernel(np.float64(0.0), SUPPORT)))
    np.add.at(rho, rows, w)
    return MASS * rho


@pytest.fixture(autouse=True)
def _no_density_plans():
    jn.clear_density_plan()
    yield
    jn.clear_density_plan()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_geoslot_matches_reference(dtype):
    pts = _block(2.0).astype(dtype)
    tpts = torch.as_tensor(pts)
    jphase = np.asarray(jn._octant_phase(pts, SUPPORT / 2.0))
    tphase = tn._octant_phase(tpts, SUPPORT / 2.0)
    np.testing.assert_allclose(tphase, jphase, rtol=0, atol=1e-3 * SUPPORT)
    lo, hi = pts.min(0), pts.max(0)
    jgrid = jn._phase_aligned_bingrid(lo, hi, SUPPORT, jphase)
    tgrid = tn._phase_aligned_bingrid(lo, hi, SUPPORT, tphase)
    assert (tgrid.min, tgrid.dims) == (jgrid.min, jgrid.dims)

    want, jok = jn.compute_particle_densities_geoslot(pts, jgrid, SUPPORT, MASS)
    got, tok = tn.compute_particle_densities_geoslot(tpts, tgrid, SUPPORT, MASS)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    # the full wrapper takes geoslot on this scene, in both packages
    full = tn.compute_particle_densities(tpts, SUPPORT, MASS)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("spacing_rel,seed,path", [(2.0, 3, "geoslot"), (1.4, 5, "raster")])
def test_densities_agree_with_naive_oracle(spacing_rel, seed, path):
    pts = _block(spacing_rel, n_side=20, seed=seed)
    tpts = torch.as_tensor(pts)
    lo, hi = pts.min(0), pts.max(0)
    agrid = tn._phase_aligned_bingrid(lo, hi, SUPPORT, tn._octant_phase(tpts, SUPPORT / 2.0))
    geoslot_ok = bool(tn.compute_particle_densities_geoslot(tpts, agrid, SUPPORT, MASS)[1])
    assert geoslot_ok == (path == "geoslot")
    if path == "raster":
        grid = tn.BinGrid.for_domain(lo, hi, SUPPORT)
        max_occ, n_bins, over8 = tn.bin_stats_ex(tn.build_cell_list(tpts, grid))
        gate = tn.density_gate(len(pts), grid.lattice, n_bins, max_occ, over8)
        assert gate["use_raster"] and gate["overflow"]
    got = tn.compute_particle_densities(tpts, SUPPORT, MASS).numpy()
    np.testing.assert_allclose(got, _oracle(pts), rtol=1e-12, atol=0)


def test_sparse_scene_takes_the_binned_formulation():
    """A sparse cloud fails the dense gate and takes the sort-based binned
    formulation; its densities agree with the brute-force oracle and with
    the reference."""
    pts = np.random.default_rng(1).uniform(0, 1, (2000, 3))
    got = tn.compute_particle_densities(torch.as_tensor(pts), SUPPORT, MASS).numpy()
    assert tn.LAST_GATE["kind"] == "binned8"
    np.testing.assert_allclose(got, _oracle(pts), rtol=1e-12, atol=0)
    want = np.asarray(jn.compute_particle_densities(pts, SUPPORT, MASS))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
