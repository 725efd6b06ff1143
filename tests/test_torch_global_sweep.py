"""Level set on the global grid, PyTorch port against the JAX reference:
``rasterize_global`` (slot rasters and the overflow set at lane_align=1)
and ``sweep_global`` (kernel K1's plain version plus the overflow scatter)
against the reference's "scan" backend."""

import numpy as np
import pytest
import torch

from splashsurf_tpu.aabb import Aabb3d as JAabb
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.uniform_grid import UniformGrid as TGrid
from splashsurf_tpu_torch.uniform_grid import kernel_extents

SUPPORT = 0.1
# the reference's own bar for kernel against scan (test_reconstruct_global)
TOL = {np.float32: dict(rtol=2e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-14)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n, dtype, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.1, 0.9, (n, 3)).astype(dtype)
    vals = rng.uniform(0.5, 2.0, (n,)).astype(dtype)
    jgrid = JGrid.from_aabb(JAabb((-0.1,) * 3, (1.1,) * 3), 0.0375)
    tgrid = TGrid(min=jgrid.min, cell_size=jgrid.cell_size, n_cells=jgrid.n_cells)
    hsc = kernel_extents(SUPPORT, jgrid.cell_size).half_supported_cells
    return pts, vals, jgrid, tgrid, hsc


def _reference(pts, vals, jgrid, slots, hsc):
    r = jgs.rasterize_global(pts, vals, jgrid, slots, hsc, 4096, lane_align=1)
    return r, int(r[8])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_rasterize_equals_reference(dtype, slots):
    """Rasters and the overflow set are bit-identical: the fractions
    px - (mn + cell * cs) round mn + cell * cs once, as the reference's
    fused multiply-add does."""
    pts, vals, jgrid, tgrid, hsc = _scene(1500, dtype, seed=slots)
    r, n_over = _reference(pts, vals, jgrid, slots, hsc)
    rasters, overflow = tgs.rasterize_global(
        torch.as_tensor(pts), torch.as_tensor(vals), tgrid, slots, hsc
    )
    for got, want in zip(rasters, r[:4]):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert overflow[0].shape[0] == n_over
    assert (n_over > 0) == (slots < 4)
    for got, want in zip(overflow, r[4:8]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n_over])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_sweep_matches_reference_scan(dtype, slots):
    """On the reference's own rasters. slots 1 and 2 overflow (scatter
    splat of the overflow particles), 4 does not (raster sweep alone)."""
    pts, vals, jgrid, tgrid, hsc = _scene(1500, dtype, seed=10 + slots)
    r, n_over = _reference(pts, vals, jgrid, slots, hsc)
    want = np.asarray(jgs.sweep_global(*r[:8], jgrid, SUPPORT, hsc, "scan"))
    rasters = tuple(torch.as_tensor(np.array(a)) for a in r[:4])
    overflow = tuple(torch.as_tensor(np.array(a)[:n_over]) for a in r[4:8])
    got = tgs.sweep_global(rasters, overflow, tgrid, SUPPORT, hsc).numpy()
    assert got.shape == tgrid.n_points and got.dtype == dtype
    assert want.max() > 1.0
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("slots", [1, 2])
def test_rasterize_and_sweep_f64_end_to_end(slots):
    """The port's own rasters through its sweep, in f64, where the fused
    multiply-add of the reference moves the fractions by ~1e-16 only."""
    pts, vals, jgrid, tgrid, hsc = _scene(1500, np.float64, seed=20 + slots)
    r, _ = _reference(pts, vals, jgrid, slots, hsc)
    want = np.asarray(jgs.sweep_global(*r[:8], jgrid, SUPPORT, hsc, "scan"))
    rasters, overflow = tgs.rasterize_global(
        torch.as_tensor(pts), torch.as_tensor(vals), tgrid, slots, hsc
    )
    got = tgs.sweep_global(rasters, overflow, tgrid, SUPPORT, hsc).numpy()
    np.testing.assert_allclose(got, want, **TOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_far_corner_particle(dtype):
    """A particle in the last cell reaches the far point planes."""
    jgrid = JGrid(min=(0.0, 0.0, 0.0), cell_size=0.0375, n_cells=(30, 21, 27))
    tgrid = TGrid(min=jgrid.min, cell_size=jgrid.cell_size, n_cells=jgrid.n_cells)
    hsc = kernel_extents(SUPPORT, jgrid.cell_size).half_supported_cells
    far = np.asarray(jgrid.min) + np.asarray(jgrid.n_cells) * jgrid.cell_size
    pts = (far - 0.2 * jgrid.cell_size)[None].astype(dtype)
    vals = np.ones((1,), dtype)
    r, _ = _reference(pts, vals, jgrid, 2, hsc)
    want = np.asarray(jgs.sweep_global(*r[:8], jgrid, SUPPORT, hsc, "scan"))
    rasters, overflow = tgs.rasterize_global(
        torch.as_tensor(pts), torch.as_tensor(vals), tgrid, 2, hsc
    )
    got = tgs.sweep_global(rasters, overflow, tgrid, SUPPORT, hsc).numpy()
    assert want[-1].max() > 0 and got[-1].max() > 0
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_out_of_grid_particles_are_dropped():
    tgrid = TGrid(min=(0.0, 0.0, 0.0), cell_size=0.1, n_cells=(5, 5, 5))
    pts = torch.tensor([[0.25, 0.25, 0.25], [-0.05, 0.2, 0.2], [0.2, 0.7, 0.2]])
    rasters, overflow = tgs.rasterize_global(pts, torch.ones(3), tgrid, 1, 1)
    assert int((rasters[3] > 0).sum()) == 1 and overflow[0].numel() == 0
