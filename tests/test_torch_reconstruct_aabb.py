"""``reconstruct_surface`` with a particle AABB filter, PyTorch port against
the JAX reference in f64: the same particles are kept, the grid comes from
the AABB, and the vertex and triangle lists are equal."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_particle_aabb_filter_matches_reference():
    pts = bench.make_dam_break(3000, RADIUS, seed=2).astype(np.float64)
    lo, hi = pts.min(0), pts.max(0)
    cut = lo + 0.6 * (hi - lo)
    jp = st.Parameters.new_relative(
        RADIUS, 4.0, 1.5, particle_aabb=st.Aabb3d(tuple(lo - 0.01), tuple(cut)),
        dtype="float64",
    )
    jn.clear_density_plan()
    clear_grid_plan()
    ref = st.reconstruct_surface(pts, jp)
    rec = pt.reconstruct_surface(
        torch.as_tensor(pts), pt.Parameters.from_reference(jp)
    )
    np.testing.assert_array_equal(rec.particle_inside_aabb, np.asarray(ref.particle_inside_aabb))
    assert 0 < rec.particle_inside_aabb.sum() < len(pts)
    assert (rec.grid.min, rec.grid.n_cells) == (ref.grid.min, ref.grid.n_cells)
    np.testing.assert_array_equal(rec.mesh.triangles, np.asarray(ref.mesh.triangles))
    np.testing.assert_allclose(
        rec.mesh.vertices, np.asarray(ref.mesh.vertices), rtol=0, atol=1e-12
    )
    assert rec.mesh.num_triangles > 500
    assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None
