"""The port's SPH interpolation against the JAX package's
``sph_interpolation`` on a seeded dam break with seeded densities: normals,
scalar and vector quantities with and without the first-order (Shepard)
correction, weighted neighbour counts and ``smooth_step``, with queries
inside the fluid, on particles (r = 0) and far from any particle (f32 rtol
2e-5 / atol 1e-5, f64 rtol 1e-10). The query chunking changes no bit; f32
queries of f64 particles run in f64."""

import numpy as np
import pytest
import torch

import bench
from splashsurf_tpu import sph_interpolation as js

from splashsurf_tpu_torch import sph_interpolation as ts

H = 0.044
MASS = (2 * 0.011) ** 3 * 1000.0
TOL = {np.float32: dict(rtol=2e-5, atol=1e-5), np.float64: dict(rtol=1e-10, atol=1e-12)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    g = np.random.default_rng(7)
    pos = bench.make_dam_break(1500, 0.011, seed=5)
    rho = g.uniform(900.0, 1100.0, len(pos))
    lo, hi = pos.min(0), pos.max(0)
    queries = np.concatenate([
        g.uniform(lo - H, hi + H, (400, 3)),  # inside, near and beyond the fluid
        pos[:50],  # on particles: r = 0 terms
        [hi + 5.0 * H],  # no neighbour at all
        [lo - 3.0 * H],
    ])
    scalar = g.standard_normal(len(pos))
    vector = g.standard_normal((len(pos), 3))
    return pos, rho, queries, scalar, vector


def _pair(scene, dtype):
    pos, rho, queries, scalar, vector = (np.asarray(a, dtype) for a in scene)
    j = js.SphInterpolator(pos, rho, MASS, H)
    t = ts.SphInterpolator(pos, torch.as_tensor(rho), MASS, H)
    return j, t, queries, scalar, vector


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normals(scene, dtype):
    j, t, queries, _, _ = _pair(scene, dtype)
    got = t.interpolate_normals(queries)
    assert isinstance(got, np.ndarray) and got.dtype == dtype
    np.testing.assert_allclose(got, np.asarray(j.interpolate_normals(queries)), **TOL[dtype])
    np.testing.assert_array_equal(got[-2:], 0.0)  # no neighbour: a zero gradient
    norms = np.linalg.norm(got[:-2], axis=1)
    assert (norms > 0.5).sum() > 300  # most queries have neighbours
    assert np.minimum(np.abs(norms - 1), norms).max() < 1e-4  # unit or zero


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("corrected", [False, True])
def test_quantities(scene, dtype, corrected):
    j, t, queries, scalar, vector = _pair(scene, dtype)
    got = t.interpolate_scalar_quantity(scalar, queries, first_order_correction=corrected)
    want = np.asarray(j.interpolate_scalar_quantity(scalar, queries, first_order_correction=corrected))
    assert got.shape == (len(queries),) and got.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])
    got_v = t.interpolate_vector_quantity(vector, queries, first_order_correction=corrected)
    want_v = np.asarray(j.interpolate_vector_quantity(vector, queries, first_order_correction=corrected))
    assert got_v.shape == (len(queries), 3)
    np.testing.assert_allclose(got_v, want_v, **TOL[dtype])
    np.testing.assert_array_equal(got_v[-2:], 0.0)
    # rank dispatch
    np.testing.assert_array_equal(
        t.interpolate_quantity(vector, queries, first_order_correction=corrected), got_v
    )
    np.testing.assert_array_equal(
        t.interpolate_quantity(scalar, queries, first_order_correction=corrected), got
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_weighted_neighbor_counts(scene, dtype):
    pos = np.asarray(scene[0], dtype)
    got = ts.compute_weighted_neighbor_counts(pos, H, device="cpu")
    assert got.dtype == dtype and got.shape == (len(pos),)
    np.testing.assert_allclose(got, np.asarray(js.compute_weighted_neighbor_counts(pos, H)), **TOL[dtype])
    # a lone particle has no neighbour (its own term is left out)
    lone = np.concatenate([pos, pos.max(0, keepdims=True) + 10 * H])
    assert ts.compute_weighted_neighbor_counts(torch.as_tensor(lone), H)[-1] == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpolator_counts_on_its_own_bins(scene, dtype):
    # the pipeline bins the particles once: the interpolator's counts are
    # the function's, bit for bit
    pos = np.asarray(scene[0], dtype)
    t = ts.SphInterpolator(pos, np.asarray(scene[1], dtype), MASS, H, device="cpu")
    np.testing.assert_array_equal(
        t.weighted_neighbor_counts(), ts.compute_weighted_neighbor_counts(pos, H, device="cpu")
    )


def test_smooth_step():
    x = np.linspace(-0.5, 1.5, 101)
    np.testing.assert_array_equal(ts.smooth_step(x), js.smooth_step(x))


def test_chunking_changes_nothing(scene, monkeypatch):
    _, t, queries, scalar, _ = _pair(scene, np.float64)
    whole = t.interpolate_scalar_quantity(scalar, queries, first_order_correction=True)
    normals = t.interpolate_normals(queries)
    wnn = ts.compute_weighted_neighbor_counts(scene[0], H, device="cpu")
    monkeypatch.setattr(ts, "CHUNK_ELEMENTS", 7 * t.capacity)
    np.testing.assert_array_equal(
        t.interpolate_scalar_quantity(scalar, queries, first_order_correction=True), whole
    )
    np.testing.assert_array_equal(t.interpolate_normals(queries), normals)
    np.testing.assert_array_equal(ts.compute_weighted_neighbor_counts(scene[0], H, device="cpu"), wnn)


def test_f32_queries_of_f64_particles_run_in_f64(scene):
    _, t, queries, scalar, _ = _pair(scene, np.float64)
    q32 = queries.astype(np.float32)
    got = t.interpolate_scalar_quantity(scalar, q32, first_order_correction=True)
    assert got.dtype == np.float64
    np.testing.assert_allclose(
        got, t.interpolate_scalar_quantity(scalar, q32.astype(np.float64), first_order_correction=True),
        rtol=1e-12, atol=1e-12,
    )


def test_arrays_go_to_cuda_by_default(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.SphInterpolator(scene[0], scene[1], MASS, H)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.compute_weighted_neighbor_counts(scene[0], H)
    # densities on a device take the positions there
    t = ts.SphInterpolator(scene[0], torch.as_tensor(scene[1]), MASS, H)
    assert t.positions.device.type == "cpu" and t.size() == len(scene[0])
