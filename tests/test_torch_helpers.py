"""The port's small helpers against the JAX package's on the CPU: the kernel
helpers and the table kernel (1e-6 relative in f32, 1e-12 in f64), the
topology value types and ``aabb_from_points`` (equal),
``par_laplacian_smoothing_inplace`` (1e-5), ``global_pipeline.
compute_densities``, ``subdomains.chunk_mc_counts`` on the small canyon's
chunks (equal, and consistent with ``chunk_mc``) and the slab gate's
reference name."""

import numpy as np
import pytest
import torch

import splashsurf_tpu as st
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import kernels as jk
from splashsurf_tpu import postprocess as jpp
from splashsurf_tpu import subdomains as js
from splashsurf_tpu import topology as jtop
from splashsurf_tpu.aabb import aabb_from_points as j_aabb

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import kernels as tk
from splashsurf_tpu_torch import postprocess as tpp
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch import topology as ttop
from splashsurf_tpu_torch.aabb import aabb_from_points as t_aabb
from test_torch_subdomains import _chunk_inputs, _setup, canyon  # noqa: F401 (fixture)
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)
from torch_meshes import icosphere

H = 0.1
TOL = {np.float32: dict(rtol=1e-6), np.float64: dict(rtol=1e-12)}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype):
    """Relative ``TOL`` of the largest magnitude (the gradient and the
    spline pass through 0)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype]["rtol"] * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cubic_kernel_rsq_and_gradient(dtype):
    rng = np.random.default_rng(0)
    dx = rng.uniform(-0.6 * H, 0.6 * H, (500, 3)).astype(dtype)
    dx[:3] = 0.0  # the origin: a zero gradient
    r_sq = (dx**2).sum(1)
    got = tk.cubic_kernel_rsq(torch.as_tensor(r_sq), H)
    assert got.dtype == TORCH[dtype]
    _close(got.numpy(), jk.cubic_kernel_rsq(r_sq, H), dtype)
    grad = tk.cubic_kernel_gradient(torch.as_tensor(dx), H)
    assert grad.shape == dx.shape and grad.dtype == TORCH[dtype]
    _close(grad.numpy(), jk.cubic_kernel_gradient(dx, H), dtype)
    assert (grad[:3] == 0).all() and torch.isfinite(grad).all()
    assert (grad.norm(dim=1)[3:] > 0).any() and (r_sq > H * H / 4).any()


def test_particle_volumes():
    for r in (0.025, 0.5, 1.0):
        assert tk.cube_particle_volume(r) == jk.cube_particle_volume(r)
        assert tk.sphere_particle_volume(r) == jk.sphere_particle_volume(r)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_discrete_squared_distance_kernel(dtype):
    tab_t = tk.DiscreteSquaredDistanceCubicKernel(1000, H, dtype)
    tab_j = jk.DiscreteSquaredDistanceCubicKernel(1000, H, dtype)
    assert tab_t.values.dtype == TORCH[dtype]
    np.testing.assert_array_equal(tab_t.values.numpy(), np.asarray(tab_j.values))
    r_sq = np.random.default_rng(1).uniform(0, 1.2 * H * H, 2000).astype(dtype)
    r_sq[:2] = (0.0, H * H)
    got = tab_t.evaluate(torch.as_tensor(r_sq))
    want = np.asarray(tab_j.evaluate(r_sq))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    assert float(got[1]) == 0.0 and (got.numpy()[r_sq >= H * H] == 0).all()
    # the table approximates W to its sampling step
    exact = np.asarray(jk.cubic_kernel_rsq(r_sq.astype(np.float64), H))
    assert np.abs(got.numpy() - exact).max() < 0.01 * exact.max()


def test_topology_equals_the_reference():
    assert [int(a) for a in ttop.Axis] == [int(a) for a in jtop.Axis] == [0, 1, 2]
    for a in range(3):
        assert [int(x) for x in ttop.Axis(a).orthogonal_axes()] == [
            int(x) for x in jtop.Axis(a).orthogonal_axes()]
    for d in (0, 1):
        assert ttop.Direction(d).sign == jtop.Direction(d).sign
        assert int(ttop.Direction(d).opposite()) == int(jtop.Direction(d).opposite())
    tall, jall = ttop.DirectedAxis.all(), jtop.DirectedAxis.all()
    assert len(tall) == len(jall) == 6
    dims = (3, 4, 5)
    for t, j in zip(tall, jall):
        np.testing.assert_array_equal(t.offset, j.offset)
        np.testing.assert_array_equal(t.opposite().offset, j.opposite().offset)
        for ijk in [(0, 0, 0), (2, 3, 4), (1, 2, 2)]:
            a, b = ttop.checked_apply_step(ijk, t, dims), jtop.checked_apply_step(ijk, j, dims)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_aabb_from_points(dtype):
    pts = np.random.default_rng(2).normal(size=(300, 3)).astype(dtype)
    lo, hi = t_aabb(torch.as_tensor(pts))
    jlo, jhi = j_aabb(pts)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == TORCH[dtype]


def test_par_laplacian_smoothing_inplace():
    sphere = icosphere(2, np.float32)
    verts = sphere.vertices * np.float32([1.0, 0.8, 1.3])
    tris = sphere.triangles
    weights = np.linspace(0.3, 1.0, len(verts)).astype(np.float32)
    tmesh = pt.TriMesh3d(vertices=verts.copy(), triangles=tris.copy())
    jmesh = st.TriMesh3d(vertices=verts.copy(), triangles=tris.copy())
    out = tpp.par_laplacian_smoothing_inplace(tmesh, None, 4, 0.5, weights, device="cpu")
    jpp.par_laplacian_smoothing_inplace(jmesh, None, 4, 0.5, weights)
    assert out is tmesh and not np.array_equal(tmesh.vertices, verts)
    np.testing.assert_allclose(tmesh.vertices, np.asarray(jmesh.vertices), rtol=0, atol=1e-5)


def test_compute_densities():
    # a jittered rest lattice (spacing 2r): the geoslot formulation in both
    rng = np.random.default_rng(3)
    coords = (np.arange(12) + 0.5) * 0.02
    pts = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), -1).reshape(-1, 3)
    pts = (pts + rng.uniform(-0.002, 0.002, pts.shape) + 0.1234).astype(np.float32)
    tparams = pt.Parameters.new_relative(0.01, 4.0, 1.0)
    jparams = st.Parameters.new_relative(0.01, 4.0, 1.0)
    got = tgp.compute_densities(torch.as_tensor(pts), tparams)
    want = np.asarray(jgp.compute_densities(pts, jparams))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    assert got.shape == (len(pts),)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_mc_counts_on_the_canyon_chunks(canyon, dtype):
    pts = canyon.astype(dtype)
    jp, sd_j, sd_t = _setup(pts, 8, 1.5, dtype)
    ja, ta = _chunk_inputs(pts, sd_j, dtype)
    hsc = sd_t.margin_cells
    ls = ts.chunk_levelset_raster(
        ta["positions"], ta["values"], ta["pids"], ta["rows"], ta["cells"], ta["ranks"],
        ta["sub_ijk"], sd_t, jp.compact_support_radius, hsc,
    )
    iso = float(np.quantile(ls.numpy()[ls.numpy() > 0], 0.4))
    want = [np.asarray(c) for c in js.chunk_mc_counts(ls.numpy(), sd_j, iso)]
    got = [c.numpy() for c in ts.chunk_mc_counts(ls, sd_t, iso)]
    for name, g, w in zip(("vertices", "triangles", "boundary vertices"), got, want):
        assert g.shape == (ls.shape[0],)
        np.testing.assert_array_equal(g, w, err_msg=name)
    nv, nt, nb = got
    assert nt.sum() > 0 and 0 < nb.sum() < nv.sum()
    # the same counting as the chunk's marching cubes
    verts, keys, tris = ts.chunk_mc(ls, ta["sub_ijk"], sd_t, iso)
    assert verts.shape[0] == nv.sum() and tris.shape[0] == nt.sum()


def test_slab_gate_has_the_reference_name(monkeypatch):
    from splashsurf_tpu.ops import slab_sweep as jslab
    from splashsurf_tpu_torch.ops import slab_sweep as tslab

    assert tslab.gs_dense_gate() == jslab.gs_dense_gate() == 48_000_000
    monkeypatch.setenv("SPLASHSURF_TPU_SLAB_CELLS_BUDGET", "12345")
    assert tslab.gs_dense_gate() == jslab.gs_dense_gate() == 12345
    assert not hasattr(tslab, "slab_cells_budget")
