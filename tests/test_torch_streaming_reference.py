"""The subdomain route's streamed mode in the PyTorch port against the JAX
package's streamed run (``SPLASHSURF_TPU_STREAM=1``), on its raster path
and its device stitch: in f64 the same triangle soup, in f32 equal counts
and vertices within 1e-4."""

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


def _closed(mesh):
    return pt.check_mesh_consistency(mesh.vertices, mesh.triangles) is None


def _soup(mesh, cell_size):
    """Sorted triangles as corner coordinates in cell units (rounded), so
    that two meshes compare independently of vertex and triangle order."""
    tri = np.round(np.asarray(mesh.vertices)[np.asarray(mesh.triangles)] / cell_size, 3)
    return sorted(tuple(sum(sorted(map(tuple, t)), ())) for t in tri)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_reference_streamed(dtype, monkeypatch):
    """The reference's streamed run on its raster path (its scan twin of K3
    on the CPU) and its device stitch."""
    monkeypatch.setenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", "0")
    monkeypatch.setenv(ts.STREAM_ENV, "1")
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
    assert js.LAST_RUN["streamed"]
    rec = pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")
    assert ts.LAST_RUN["streamed"] and ts.LAST_RUN["B"] == js.LAST_RUN["B"] > 4
    counts = (rec.mesh.num_vertices, rec.mesh.num_triangles)
    assert counts == (ref.mesh.num_vertices, ref.mesh.num_triangles)
    assert counts[1] > 1000 and _closed(rec.mesh)
    if dtype == "float64":
        assert _soup(rec.mesh, grid.cell_size) == _soup(ref.mesh, grid.cell_size)
    else:
        d, _ = cKDTree(np.asarray(ref.mesh.vertices)).query(rec.mesh.vertices)
        assert d.max() < 1e-4
