"""The sorted raster density formulation with its overflow correction,
PyTorch port against the JAX reference, on a compressed block where the
geoslot octants collide and bins hold more than 8 particles."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import neighbors as jn

from splashsurf_tpu_torch import neighbors as tn
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011
SUPPORT = 4 * RADIUS
MASS = 1.0
# the same sums in the same order up to the kernels' rounding, except the
# overflow correction's reductions
TOL = {np.float32: dict(rtol=2e-6, atol=0), np.float64: dict(rtol=1e-12, atol=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compressed_block(n_side=28, seed=5):
    """A jittered lattice block at 1.6 particle radii spacing (compressed
    fluid) at an arbitrary offset."""
    rng = np.random.default_rng(seed)
    spacing = 1.6 * RADIUS
    c = (np.arange(n_side) + 0.5) * spacing
    X, Y, Z = np.meshgrid(c, c[: n_side // 2], c[: n_side // 2], indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    pts += rng.uniform(-0.25, 0.25, pts.shape) * spacing
    return pts + 0.317


@pytest.fixture(autouse=True)
def _no_density_plans():
    jn.clear_density_plan()
    yield
    jn.clear_density_plan()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raster_with_overflow_matches_reference(dtype):
    """A compressed block: octants collide (geoslot declines) and bins hold
    more than 8 particles, so the raster formulation runs with the exact
    overflow correction."""
    pts = _compressed_block().astype(dtype)
    tpts = torch.as_tensor(pts)
    want = np.asarray(jn.compute_particle_densities(pts, SUPPORT, MASS))
    gate = jn.LAST_GATE["single"]
    assert gate["use_raster"] and gate["max_occ"] > 8 and gate["ocap"] > 0

    grid = tn.BinGrid.for_domain(pts.min(0), pts.max(0), SUPPORT)
    max_occ, n_bins, over8 = tn.bin_stats_ex(tn.build_cell_list(tpts, grid))
    if dtype == np.float64:
        assert (max_occ, n_bins, over8) == (gate["max_occ"], gate["n_bins"], gate["over8"])
    # in f32 the reference's XLA build multiplies by 1/bin_size instead of
    # dividing, which moves a few boundary particles to the next bin; the
    # decision it leads to is the same
    tgate = tn.density_gate(len(pts), grid.lattice, n_bins, max_occ, over8)
    assert tgate["use_raster"] and tgate["overflow"]
    agrid = tn._phase_aligned_bingrid(
        pts.min(0), pts.max(0), SUPPORT, tn._octant_phase(tpts, SUPPORT / 2.0)
    )
    assert not bool(tn.compute_particle_densities_geoslot(tpts, agrid, SUPPORT, MASS)[1])

    got = tn.compute_particle_densities(tpts, SUPPORT, MASS)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
