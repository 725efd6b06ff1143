"""The port's density splat API (``splashsurf_tpu_torch.density``) against
the JAX package's ``splashsurf_tpu.density`` on the CPU: the raster splat
and the scatter oracle on the reference's own cases
(``tests/test_reconstruct_global.py``, rtol 2e-5, atol 1e-4), an overflow
list cut short by its capacity, float64 within 1e-10, the raster tables
themselves, the raster sweep on a shifted point range, and the wrapper that
retries the overflow capacity."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import density as jd
from splashsurf_tpu.aabb import Aabb3d as JAabb
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid
from splashsurf_tpu.uniform_grid import kernel_extents

from splashsurf_tpu_torch import density as td
from splashsurf_tpu_torch.aabb import Aabb3d as TAabb
from splashsurf_tpu_torch.uniform_grid import UniformGrid as TGrid

SUPPORT = 0.1
F32 = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids():
    box = ((-0.1,) * 3, (1.1,) * 3)
    return JGrid.from_aabb(JAabb(*box), 0.0375), TGrid.from_aabb(TAabb(*box), 0.0375)


def _cloud(n, seed, dtype=np.float32, ones=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.1, 0.9, (n, 3)).astype(dtype)
    vals = np.ones(n, dtype) if ones else rng.uniform(0.5, 2.0, (n,)).astype(dtype)
    return pts, vals


def _hsc(grid):
    return kernel_extents(SUPPORT, grid.cell_size).half_supported_cells


def test_raster_matches_scatter():
    jg, tg = _grids()
    pts, vals = _cloud(1500, 1)
    hsc = _hsc(jg)
    ref = np.asarray(jd.splat_level_set_scatter(pts, vals, jg, SUPPORT, hsc))
    jout, jover = jd.splat_level_set(pts, vals, jg, SUPPORT, hsc, slots=4, overflow_capacity=4096)
    tout, tover = td.splat_level_set(
        pts, vals, tg, SUPPORT, hsc, slots=4, overflow_capacity=4096, device="cpu")
    tscat = td.splat_level_set_scatter(pts, vals, tg, SUPPORT, hsc, device="cpu")
    assert int(tover) == int(jover) == 0
    assert tout.shape == tscat.shape == ref.shape == tg.n_points
    np.testing.assert_allclose(tout.numpy(), ref, **F32)
    np.testing.assert_allclose(tscat.numpy(), ref, **F32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
    assert ref.max() > 1.0


def test_overflow_path_matches():
    jg, tg = _grids()
    pts, vals = _cloud(800, 2, ones=True)
    hsc = _hsc(jg)
    ref = np.asarray(jd.splat_level_set_scatter(pts, vals, jg, SUPPORT, hsc))
    jout, jover = jd.splat_level_set(pts, vals, jg, SUPPORT, hsc, slots=1, overflow_capacity=2048)
    tout, tover = td.splat_level_set(
        pts, vals, tg, SUPPORT, hsc, slots=1, overflow_capacity=2048, device="cpu")
    assert 0 < int(tover) == int(jover) <= 2048  # slots=1 must overflow on this cloud
    np.testing.assert_allclose(tout.numpy(), ref, **F32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)


def test_overflow_past_the_capacity_is_cut_as_the_reference_cuts_it():
    jg, tg = _grids()
    pts, vals = _cloud(800, 2, ones=True)
    hsc = _hsc(jg)
    jout, jover = jd.splat_level_set(pts, vals, jg, SUPPORT, hsc, slots=1, overflow_capacity=16)
    tout, tover = td.splat_level_set(
        pts, vals, tg, SUPPORT, hsc, slots=1, overflow_capacity=16, device="cpu")
    assert int(tover) == int(jover) > 16  # the true count, past the capacity
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
    full = np.asarray(jd.splat_level_set_scatter(pts, vals, jg, SUPPORT, hsc))
    assert np.abs(tout.numpy() - full).max() > 0.1  # the dropped particles are missing


@pytest.mark.parametrize("slots", [1, 4])
def test_float64_within_1e10(slots):
    jg, tg = _grids()
    pts, vals = _cloud(1200, 3, dtype=np.float64)
    hsc = _hsc(jg)
    ref = np.asarray(jd.splat_level_set_scatter(pts, vals, jg, SUPPORT, hsc))
    jout, jover = jd.splat_level_set(pts, vals, jg, SUPPORT, hsc, slots=slots, overflow_capacity=4096)
    tscat = td.splat_level_set_scatter(pts, vals, tg, SUPPORT, hsc, device="cpu")
    tout, tover = td.splat_level_set(
        pts, vals, tg, SUPPORT, hsc, slots=slots, overflow_capacity=4096, device="cpu")
    assert tout.dtype == tscat.dtype == torch.float64
    assert int(tover) == int(jover)
    np.testing.assert_allclose(tscat.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tout.numpy(), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("capacity", [4, 256])
def test_rasterize_particles_equals_the_reference(capacity):
    jg, tg = _grids()
    pts, vals = _cloud(900, 4)
    pts[:40] = pts[0] + np.random.default_rng(5).uniform(0, 1e-3, (40, 3)).astype(np.float32)
    jr = jd.rasterize_particles(pts, vals, jg, 2, capacity)
    tr = td.rasterize_particles(pts, vals, tg, 2, capacity, device="cpu")
    assert isinstance(tr, td.RasterizedParticles)
    assert tr._fields == jr._fields
    for name in ("pos", "val", "overflow_pos", "overflow_val"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), name)
    assert int(tr.num_overflow) == int(jr.num_overflow) > 4


def test_rasterize_particles_with_given_ranks():
    jg, tg = _grids()
    pts, vals = _cloud(300, 6)
    ranks = np.random.default_rng(7).integers(0, 3, 300).astype(np.int32)
    jr = jd.rasterize_particles(pts, vals, jg, 2, 256, ranks=ranks)
    tr = td.rasterize_particles(pts, vals, tg, 2, 256, ranks=torch.as_tensor(ranks), device="cpu")
    for name in ("pos", "val", "overflow_pos", "overflow_val"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), name)
    assert int(tr.num_overflow) == int(jr.num_overflow) == int((ranks >= 2).sum())


def test_raster_sweep_on_a_shifted_point_range():
    box = ((0.0,) * 3, (0.5,) * 3)
    jsub, tsub = JGrid.from_aabb(JAabb(*box), 0.05), TGrid.from_aabb(TAabb(*box), 0.05)
    rng = np.random.default_rng(8)
    pts = rng.uniform(0.05, 0.45, (200, 3)).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, 200).astype(np.float32)
    hsc = kernel_extents(SUPPORT, 0.05).half_supported_cells
    jr = jd.rasterize_particles(pts, vals, jsub, 4, 64)
    tr = td.rasterize_particles(pts, vals, tsub, 4, 64, device="cpu")
    for po in [(0, 0, 0), (1, 2, 0), (2, 0, 1)]:
        want = np.asarray(jd._splat_raster_sweep(jr, jsub, SUPPORT, hsc, point_offset=po))
        got = td._splat_raster_sweep(tr, tsub, SUPPORT, hsc, point_offset=po)
        np.testing.assert_allclose(got.numpy(), want, **F32)


def test_auto_retries_the_overflow_capacity(monkeypatch):
    jg, tg = _grids()
    pts, vals = _cloud(1000, 9, ones=True)
    clump = pts[:1] + np.random.default_rng(10).uniform(0, 1e-3, (700, 3)).astype(np.float32)
    pts = np.concatenate([pts, clump])
    vals = np.ones(len(pts), np.float32)
    capacities = []
    splat = td.splat_level_set

    def spy(*args, **kwargs):
        capacities.append(kwargs["overflow_capacity"])
        return splat(*args, **kwargs)

    monkeypatch.setattr(td, "splat_level_set", spy)
    got = td.splat_level_set_auto(pts, vals, tg, SUPPORT, device="cpu")
    want = np.asarray(jd.splat_level_set_auto(pts, vals, jg, SUPPORT))
    assert capacities[0] == 256 and len(capacities) == 2 and capacities[1] > 2 * 256
    np.testing.assert_allclose(got.numpy(), want, **F32)
    full = np.asarray(jd.splat_level_set_scatter(pts, vals, jg, SUPPORT, _hsc(jg)))
    np.testing.assert_allclose(got.numpy(), full, **F32)


def test_scatter_chunks_change_nothing(monkeypatch):
    _, tg = _grids()
    pts, vals = _cloud(500, 11, dtype=np.float64)
    hsc = 3
    one = td.splat_level_set_scatter(pts, vals, tg, SUPPORT, hsc, device="cpu")
    monkeypatch.setattr(td, "SCATTER_CHUNK_ENTRIES", 100)  # offset blocks of 100, one row each
    many = td.splat_level_set_scatter(pts, vals, tg, SUPPORT, hsc, device="cpu")
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-12, atol=1e-12)


def test_numpy_input_defaults_to_the_card():
    _, tg = _grids()
    pts, vals = _cloud(10, 12)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.splat_level_set(pts, vals, tg, SUPPORT, 3)
