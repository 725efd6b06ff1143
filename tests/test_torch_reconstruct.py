"""End-to-end ``reconstruct_surface`` of the PyTorch port against the JAX
reference on a small synthetic dam break: in f64 the vertex and triangle
lists equal the reference's, in f32 the counts are equal and vertices lie
within 1e-4; the mesh is closed. Plus the port's entry-point contract:
explicit devices, the routes it does not have yet, and forced
decomposition taking the subdomain route."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt

RADIUS = 0.011


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return bench.make_dam_break(3000, RADIUS, seed=1)


def _reference(pts, params):
    jn.clear_density_plan()
    clear_grid_plan()
    return st.reconstruct_surface(pts, params)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_reference(scene, dtype):
    jp = st.Parameters.new_relative(RADIUS, 4.0, 1.5).try_convert(dtype)
    ref = _reference(scene.astype(dtype), jp)
    rec = pt.reconstruct_surface(
        scene.astype(dtype), pt.Parameters.from_reference(jp), device="cpu"
    )
    assert (rec.grid.min, rec.grid.n_cells) == (ref.grid.min, ref.grid.n_cells)
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    v, t = rec.mesh.vertices, rec.mesh.triangles
    assert v.dtype == np.dtype(dtype) and t.dtype == np.int32
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == rv.shape[:1] + rt.shape[:1]
    assert rec.mesh.num_triangles > 1000
    if dtype == "float64":
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12)
        dens_tol = dict(rtol=1e-12, atol=0)
    else:
        # the reference ships t quantized to 16 bits (error <= cell/65535)
        assert np.abs(v - rv).max() < 1e-4
        dens_tol = dict(rtol=2e-6, atol=0)
    assert isinstance(rec.particle_densities, torch.Tensor)
    np.testing.assert_allclose(
        rec.particle_densities.numpy(), np.asarray(ref.particle_densities), **dens_tol
    )
    assert pt.check_mesh_consistency(v, t) is None


def test_tensor_input_runs_on_its_device(scene):
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    a = pt.reconstruct_surface(torch.as_tensor(scene[:1500]), params)
    b = pt.reconstruct_surface(scene[:1500], params, device="cpu")
    np.testing.assert_array_equal(a.mesh.triangles, b.mesh.triangles)
    np.testing.assert_array_equal(a.mesh.vertices, b.mesh.vertices)
    assert a.particle_densities.device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        pt.reconstruct_surface(scene, params)
    with pytest.raises(ValueError, match="device"):
        pt.reconstruct_surface(torch.as_tensor(scene), params, device="meta")
    with pytest.raises(ValueError, match="shape"):
        pt.reconstruct_surface(scene[:, :2], params, device="cpu")


def test_grid_past_the_dense_gate_is_not_ported():
    # two particles ~10 m apart at a 1.65 cm cube: ~600^3 = 216M cells in 5
    # slabs, where the reference takes the slab route
    pts = np.asarray([[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]], np.float32)
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    with pytest.raises(NotImplementedError, match="dense gate"):
        pt.reconstruct_surface(pts, params, device="cpu")


@pytest.mark.parametrize("kw", [dict(global_neighborhood_list=True)])
def test_other_routes_are_not_ported(scene, kw):
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5, **kw)
    with pytest.raises(NotImplementedError):
        pt.reconstruct_surface(scene, params, device="cpu")


def test_forced_decomposition_takes_the_subdomain_route(scene):
    params = pt.Parameters.new_relative(
        RADIUS, 4.0, 1.5,
        grid_decomposition=pt.GridDecompositionParameters(32, auto_disable=False),
    )
    rec = pt.reconstruct_surface(scene, params, device="cpu")
    assert rec.subdomain_grid is not None
    assert rec.subdomain_grid.cell_size == 32 * rec.grid.cell_size
    dense = pt.reconstruct_surface(scene, pt.Parameters.new_relative(RADIUS, 4.0, 1.5), device="cpu")
    assert dense.subdomain_grid is None
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == (
        dense.mesh.num_vertices, dense.mesh.num_triangles
    )
    assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None
