"""``reconstruction_pipeline`` of the port against the JAX package's: the
f32 chain without topology edits (equal counts, vertices and unit normals
within 1e-4, the rest at the f32 interpolation tolerance); and the particle
AABB's plumbing. The f64 chains are in ``test_torch_pipeline.py``."""

import numpy as np
import pytest
import torch

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch.sph_interpolation import SphInterpolator
from test_torch_pipeline import _attrs, _chain, _run, scene  # noqa: F401 (fixture)
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_f32_chain_without_topology_edits(scene):
    ref, out = _run(scene, np.float32, _chain(edits=False))
    a, b = ref.tri_mesh, out.tri_mesh
    assert (b.mesh.num_vertices, b.mesh.num_triangles) == (a.mesh.num_vertices, a.mesh.num_triangles)
    assert b.mesh.vertices.dtype == np.float32
    assert np.abs(b.mesh.vertices - np.asarray(a.mesh.vertices)).max() < 1e-4
    got, want = _attrs(b), _attrs(a)
    n = got["normals"]
    assert np.abs(np.linalg.norm(n, axis=1) - 1).max() < 1e-4
    assert np.abs(n - want["normals"]).max() < 1e-4
    for name in ("wnn", "sw", "velocity"):
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], rtol=2e-5, atol=1e-4, err_msg=name)


def test_particle_aabb_filters_particles_and_attributes(scene):
    """The filtered particles and their attribute rows reach the
    interpolation (the AABB's reconstruction itself is held against the
    reference in ``test_torch_reconstruct_aabb.py``)."""
    pts, vel = scene
    params = pt.Parameters.new_relative(
        0.011, 4.0, 1.5, dtype="float64", particle_aabb=pt.Aabb3d((0.0, 0.0, 0.0), (0.68, 0.24, 0.09))
    )
    post = pt.PostprocessingParameters(interpolate_attributes=["velocity"])
    out = pt.reconstruction_pipeline(pts, params, post, {"velocity": vel}, device="cpu")
    rec = out.raw_reconstruction
    inside = rec.particle_inside_aabb
    assert 0 < inside.sum() < len(pts) and rec.particle_densities.shape == (inside.sum(),)
    alone = pt.reconstruct_surface(pts, params, device="cpu")
    np.testing.assert_array_equal(out.tri_mesh.mesh.triangles, alone.mesh.triangles)
    interp = SphInterpolator(pts[inside], rec.particle_densities, params.particle_rest_mass,
                             params.compact_support_radius)
    np.testing.assert_array_equal(
        _attrs(out.tri_mesh)["velocity"],
        interp.interpolate_vector_quantity(vel[inside], out.tri_mesh.mesh.vertices, True),
    )
