"""End-to-end ``reconstruct_surface`` of the PyTorch port against the JAX
reference on a small synthetic dam break: in f64 the vertex and triangle
lists equal the reference's, in f32 the counts are equal and vertices lie
within 1e-4; the mesh is closed. Plus the port's entry-point contract:
arrays run on CUDA unless the caller asks for the CPU, the slab route past
the dense gate, the neighbour lists, and forced decomposition taking the
subdomain route."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch.ops import slab_sweep as tslab

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


def test_tensor_input_runs_on_its_device(scene, monkeypatch):
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    a = pt.reconstruct_surface(torch.as_tensor(scene[:1500]), params)
    b = pt.reconstruct_surface(scene[:1500], params, device="cpu")
    np.testing.assert_array_equal(a.mesh.triangles, b.mesh.triangles)
    np.testing.assert_array_equal(a.mesh.vertices, b.mesh.vertices)
    assert a.particle_densities.device.type == "cpu"
    # an array without device= goes to CUDA; without CUDA that raises, it
    # never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.reconstruct_surface(scene, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(pt.reconstruct_sequence([scene], params))
    with pytest.raises(ValueError, match="device"):
        pt.reconstruct_surface(torch.as_tensor(scene), params, device="meta")
    with pytest.raises(ValueError, match="shape"):
        pt.reconstruct_surface(scene[:, :2], params, device="cpu")


def test_grid_past_the_dense_gate_is_not_ported(monkeypatch):
    """Past the dense gate, default parameters take the slab route (the
    name predates the port of that route). Two particles ~10 m apart at a
    1.65 cm cube: a bucketed 640^3 = 262M-cell grid in 6 slabs of 117
    cells, where the reference takes the slab route too; a spy stands in
    for the route, so the 262M-cell reconstruction does not run here."""
    pts = np.asarray([[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]], np.float32)
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    entered = []
    monkeypatch.setattr(
        tslab, "reconstruct_surface_slabbed",
        lambda positions, parameters, grid, **kw: entered.append(grid),
    )
    pt.reconstruct_surface(pts, params, device="cpu")
    (grid,) = entered
    assert grid.total_cells > 160_000_000
    assert -(-grid.n_cells[0] // tslab.slab_width_cells(grid, tslab.slab_cells_budget())) == 6


@pytest.mark.parametrize("kw", [dict(global_neighborhood_list=True)])
def test_other_routes_are_not_ported(scene, kw):
    """``global_neighborhood_list`` (once not ported) fills the particle
    neighbour lists and leaves the mesh as it is."""
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5, **kw)
    rec = pt.reconstruct_surface(scene, params, device="cpu")
    plain = pt.reconstruct_surface(scene, pt.Parameters.new_relative(RADIUS, 4.0, 1.5), device="cpu")
    assert plain.particle_neighbors is None
    assert isinstance(rec.particle_neighbors, pt.NeighborhoodLists)
    assert len(rec.particle_neighbors) == len(scene)
    assert 10 < np.mean([len(a) for a in rec.particle_neighbors]) < 100
    np.testing.assert_array_equal(rec.mesh.triangles, plain.mesh.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, plain.mesh.vertices)


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
