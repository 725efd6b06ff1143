"""End-to-end subdomain route of the PyTorch port: against the JAX
reference's ``reconstruct_surface_subdomain_grid`` on its raster path and
its stitch (f64: the same triangle soup; f32: equal counts, vertices within
1e-4), against the port's own dense route, independent of the chunking,
and the route choice of ``reconstruct_surface``."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as js
from splashsurf_tpu.params import GridDecompositionParameters as JGrid
from splashsurf_tpu.reconstruction import _bucket_grid, grid_for_reconstruction

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch import reconstruction as tr
from splashsurf_tpu_torch import subdomains as ts
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forced(radius, rel_cube=1.5, n_sub=16, **kw):
    return pt.Parameters.new_relative(
        radius, 4.0, rel_cube,
        grid_decomposition=pt.GridDecompositionParameters(n_sub, auto_disable=False), **kw,
    )


def _soup(mesh, cell_size):
    """Sorted triangles as corner coordinates in cell units (rounded), so
    that two meshes compare independently of vertex and triangle order."""
    tri = np.round(np.asarray(mesh.vertices)[np.asarray(mesh.triangles)] / cell_size, 3)
    return sorted(tuple(sum(sorted(map(tuple, t)), ())) for t in tri)


def _closed(mesh):
    return pt.check_mesh_consistency(mesh.vertices, mesh.triangles) is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_reference(dtype, monkeypatch):
    """The reference on its raster path (its scan twin of K3 on the CPU)
    and its device stitch."""
    monkeypatch.setenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", "0")
    radius = 0.05
    pts = bench.make_canyon(3000, radius, seed=2).astype(dtype)
    jp = st.Parameters.new_relative(
        radius, 4.0, 1.5, grid_decomposition=JGrid(16, auto_disable=False)
    ).try_convert(dtype)
    grid = _bucket_grid(
        grid_for_reconstruction(pts, jp.particle_radius, jp.compact_support_radius, jp.cube_size)
    )
    jn.clear_density_plan()
    ref = js.reconstruct_surface_subdomain_grid(pts, jp, grid, raster_threshold=0)
    rec = pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")

    assert tn.LAST_GATE["kind"] == "binned8"  # a sparse sheet
    assert ts.LAST_RUN["B"] == js.LAST_RUN["B"] > 4
    assert rec.subdomain_grid is not None
    for a, b in ((rec.grid, ref.grid), (rec.subdomain_grid, ref.subdomain_grid)):
        assert (a.min, a.cell_size, a.n_cells) == (b.min, b.cell_size, b.n_cells)
    assert rec.mesh.vertices.dtype == np.dtype(dtype)
    counts = (rec.mesh.num_vertices, rec.mesh.num_triangles)
    assert counts == (ref.mesh.num_vertices, ref.mesh.num_triangles)
    assert counts[1] > 1000 and _closed(rec.mesh)
    np.testing.assert_allclose(
        rec.particle_densities.numpy(), np.asarray(ref.particle_densities),
        rtol=1e-10 if dtype == "float64" else 2e-5,
    )
    if dtype == "float64":
        assert _soup(rec.mesh, grid.cell_size) == _soup(ref.mesh, grid.cell_size)
    else:
        d, _ = cKDTree(np.asarray(ref.mesh.vertices)).query(rec.mesh.vertices)
        assert d.max() < 1e-4


@pytest.fixture(scope="module")
def dam():
    return bench.make_dam_break(3000, 0.011, seed=1)


def test_matches_dense_route(dam):
    rec_s = pt.reconstruct_surface(dam, _forced(0.011), device="cpu")
    rec_d = pt.reconstruct_surface(dam, pt.Parameters.new_relative(0.011, 4.0, 1.5), device="cpu")
    assert rec_s.subdomain_grid is not None and rec_d.subdomain_grid is None
    assert rec_s.mesh.num_vertices == rec_d.mesh.num_vertices
    assert rec_s.mesh.num_triangles == rec_d.mesh.num_triangles > 1000
    d, _ = cKDTree(rec_d.mesh.vertices).query(rec_s.mesh.vertices)
    assert d.max() < 1e-4
    assert _closed(rec_s.mesh)


def test_chunk_size_invariance(dam):
    params = _forced(0.011)
    grid = _bucket_grid(
        grid_for_reconstruction(dam, params.particle_radius, params.compact_support_radius, params.cube_size)
    )
    tgrid = pt.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    pos = torch.as_tensor(dam)
    whole = ts.reconstruct_surface_subdomain_grid(pos, params, tgrid)
    assert ts.LAST_RUN["splat_chunks"] == 1
    one_by_one = ts.reconstruct_surface_subdomain_grid(pos, params, tgrid, chunk_bytes=1)
    assert ts.LAST_RUN["splat_chunks"] == ts.LAST_RUN["B"] > 1
    np.testing.assert_array_equal(one_by_one.mesh.triangles, whole.mesh.triangles)
    np.testing.assert_array_equal(one_by_one.mesh.vertices, whole.mesh.vertices)


@pytest.mark.parametrize("rel_cube", [0.5, 1.0, 1.5])
def test_single_particle_closed_at_cube_sizes(rel_cube):
    rec = pt.reconstruct_surface(
        np.array([[0.01, -0.02, 0.03]]), _forced(0.025, rel_cube, n_sub=8), device="cpu"
    )
    assert rec.subdomain_grid is not None
    assert rec.mesh.num_triangles >= 8 and _closed(rec.mesh)


def test_unreachable_iso_gives_an_empty_mesh():
    pts = np.random.default_rng(3).uniform(0, 0.2, (500, 3)).astype(np.float32)
    rec = pt.reconstruct_surface(
        pts, _forced(0.02, 1.0, iso_surface_threshold=100.0), device="cpu"
    )
    assert rec.subdomain_grid is not None
    assert rec.mesh.num_triangles == 0 and rec.mesh.num_vertices == 0


def test_routes():
    # auto_disable on, as by default; 16-cell subdomains keep the run small
    default = pt.Parameters.new_relative(
        0.011, 4.0, 1.5, grid_decomposition=pt.GridDecompositionParameters(16)
    )
    # a small domain auto-disables the decomposition: the dense route
    small = pt.reconstruct_surface(np.zeros((1, 3)), default, device="cpu")
    assert small.subdomain_grid is None
    # 262M cells (bucketed) in 6 slabs: the slab route, as in the reference
    # (its choice is asserted without running the reconstruction)
    two = np.asarray([[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]])
    grid = pt.grid_for_reconstruction(torch.as_tensor(two), 0.011, 0.044, default.cube_size)
    assert tr.choose_route(default, tr._bucket_grid(grid)) == "slab"
    # past 2^31 grid points the reference leaves slabs for the subdomain route
    far = np.asarray([[0.0, 0.0, 0.0], [30.0, 30.0, 30.0]])
    grid = pt.grid_for_reconstruction(torch.as_tensor(far), 0.011, 0.044, default.cube_size)
    assert np.prod(np.asarray(grid.n_points, np.int64)) >= 2**31
    rec = pt.reconstruct_surface(far, default, device="cpu")
    assert rec.subdomain_grid is not None
    assert rec.mesh.num_triangles > 0 and _closed(rec.mesh)
    assert ts.LAST_RUN["B"] >= 2

