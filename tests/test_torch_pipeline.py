"""``reconstruction_pipeline`` of the port against the JAX package's on a
small seeded dam break with a seeded velocity attribute.

- No post-processing: the raw mesh.
- f64, every stage but the topology edits (smoothing weights, weighted
  smoothing, SPH normals and their smoothing, attribute interpolation):
  triangle lists equal; vertices, ``normals``, ``wnn``, ``sw`` and the
  attribute within 1e-9.
- f64, the topology edits (cleanup, decimation) with the smoothing and
  normals after them: triangle lists equal, vertices and normals within rtol
  2e-5 / atol 1e-5 (the reference's ``_finalize_collapsed`` returns f32
  vertices, and the rest of the chain runs on them).
- Quads, the mesh AABB clamp, the orientation check, a missing attribute
  and ``PostprocessingParameters.from_reference``.

``test_torch_pipeline_f32.py`` holds the f32 chain and the particle AABB.
"""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.aabb import Aabb3d as JAabb
from splashsurf_tpu.pipeline import PostprocessingParameters as JPost
from splashsurf_tpu.pipeline import reconstruction_pipeline as j_pipeline
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import pipeline as tpl
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    pts = bench.make_dam_break(3000, RADIUS, seed=1)
    vel = np.random.default_rng(0).standard_normal(pts.shape)
    return pts, vel


def _run(scene, dtype, post: JPost, **params):
    """Both pipelines on the same inputs: (reference result, port result)."""
    pts, vel = (a.astype(dtype) for a in scene)
    jp = st.Parameters.new_relative(RADIUS, 4.0, 1.5, **params).try_convert(np.dtype(dtype).name)
    jn.clear_density_plan()
    clear_grid_plan()
    ref = j_pipeline(pts, jp, post, {"velocity": vel})
    out = pt.reconstruction_pipeline(
        pts, pt.Parameters.from_reference(jp), pt.PostprocessingParameters.from_reference(post),
        {"velocity": vel}, device="cpu",
    )
    return ref, out


def _attrs(md):
    return {a.name: np.asarray(a.data) for a in md.point_attributes}


def _chain(edits: bool, interpolation: bool = True, **kw):
    return JPost(
        mesh_cleanup=edits, decimate_barnacles=edits, mesh_smoothing_iters=25,
        mesh_smoothing_weights=interpolation, output_mesh_smoothing_weights=interpolation,
        compute_normals=True, sph_normals=interpolation, normals_smoothing_iters=10,
        interpolate_attributes=["velocity"] if interpolation else None,
        check_mesh_closed=True, check_mesh_manifold=True, **kw,
    )


def test_no_postprocessing_equals_the_raw_mesh(scene):
    ref, out = _run(scene, np.float64, JPost())
    rec = pt.reconstruct_surface(scene[0], pt.Parameters.new_relative(RADIUS, 4.0, 1.5, dtype="float64"),
                                 device="cpu")
    mesh = out.tri_mesh.mesh
    np.testing.assert_array_equal(mesh.triangles, rec.mesh.triangles)
    np.testing.assert_array_equal(mesh.vertices, rec.mesh.vertices)
    np.testing.assert_array_equal(mesh.triangles, np.asarray(ref.tri_mesh.mesh.triangles))
    assert out.tri_quad_mesh is None and out.tri_mesh.point_attributes == []
    assert isinstance(out.raw_reconstruction, pt.SurfaceReconstruction)


def test_f64_chain_without_topology_edits(scene):
    ref, out = _run(scene, np.float64, _chain(edits=False))
    a, b = ref.tri_mesh, out.tri_mesh
    np.testing.assert_array_equal(b.mesh.triangles, np.asarray(a.mesh.triangles))
    assert b.mesh.vertices.dtype == np.float64
    np.testing.assert_allclose(b.mesh.vertices, np.asarray(a.mesh.vertices), rtol=0, atol=1e-9)
    got, want = _attrs(b), _attrs(a)
    assert sorted(got) == sorted(want) == ["normals", "sw", "velocity", "wnn"]
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-9, err_msg=name)


def test_f64_chain_with_topology_edits(scene):
    ref, out = _run(scene, np.float64, _chain(edits=True, interpolation=False))
    a, b = ref.tri_mesh, out.tri_mesh
    raw = out.raw_reconstruction.mesh
    assert b.mesh.num_vertices < raw.num_vertices
    np.testing.assert_array_equal(b.mesh.triangles, np.asarray(a.mesh.triangles))
    # the reference's quirk, kept: a collapsed mesh has f32 vertices
    assert b.mesh.vertices.dtype == np.asarray(a.mesh.vertices).dtype == np.float32
    np.testing.assert_allclose(b.mesh.vertices, np.asarray(a.mesh.vertices), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(_attrs(b)["normals"], _attrs(a)["normals"], rtol=2e-5, atol=1e-5)


def test_f64_interpolation_after_topology_edits_runs_in_f64(scene):
    """The reference's scan cannot take the f32 vertices of a collapsed mesh
    against f64 particles; the port interpolates them in f64."""
    pts, vel = scene
    out = pt.reconstruction_pipeline(
        pts, pt.Parameters.new_relative(RADIUS, 4.0, 1.5, dtype="float64"),
        pt.PostprocessingParameters.from_reference(_chain(edits=True)), {"velocity": vel}, device="cpu",
    )
    attrs = _attrs(out.tri_mesh)
    assert out.tri_mesh.mesh.vertices.dtype == np.float32
    assert attrs["velocity"].dtype == attrs["normals"].dtype == attrs["wnn"].dtype == np.float64
    assert attrs["velocity"].shape == (out.tri_mesh.mesh.num_vertices, 3)
    assert np.abs(np.linalg.norm(attrs["normals"], axis=1) - 1).max() < 1e-9


def test_quads_clamp_and_checks(scene):
    clamp = JAabb((-1.0, -1.0, -1.0), (1.0, 1.0, 0.06))
    post = JPost(mesh_cleanup=True, mesh_smoothing_iters=5, compute_normals=True, generate_quads=True,
                 mesh_aabb=clamp, mesh_aabb_clamp_vertices=True, check_mesh_orientation=True,
                 output_raw_mesh=True)
    ref, out = _run(scene, np.float64, post)
    assert out.tri_mesh is None
    a, b = ref.tri_quad_mesh.mesh, out.tri_quad_mesh.mesh
    assert isinstance(b, pt.MixedTriQuadMesh3d) and len(b.quads) > 0
    for name in ("triangles", "quads"):
        np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(a, name)))
    np.testing.assert_allclose(b.vertices, np.asarray(a.vertices), rtol=2e-5, atol=1e-5)
    assert b.vertices[:, 2].max() <= 0.06
    raw = out.raw_reconstruction.mesh
    assert raw.vertices.dtype == np.float64 and raw.vertices[:, 2].max() > 0.06
    # an inverted triangle fails the orientation check
    mesh = pt.TriMesh3d(raw.vertices, raw.triangles.copy())
    assert tpl._check_orientation(mesh, "cpu") is None
    mesh.triangles[0] = mesh.triangles[0, ::-1]
    assert "inverted" in tpl._check_orientation(mesh, "cpu")


def test_missing_attribute_raises(scene):
    post = pt.PostprocessingParameters(interpolate_attributes=["pressure"])
    with pytest.raises(KeyError, match="pressure"):
        pt.reconstruction_pipeline(scene[0], pt.Parameters.new_relative(RADIUS, 4.0, 1.5), post,
                                   {"velocity": scene[1]}, device="cpu")


def test_runs_on_cuda_unless_asked_for_the_cpu(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.reconstruction_pipeline(scene[0], pt.Parameters.new_relative(RADIUS, 4.0, 1.5))
    out = pt.reconstruction_pipeline(torch.as_tensor(scene[0]), pt.Parameters.new_relative(RADIUS, 4.0, 1.5))
    assert out.tri_mesh.mesh.num_triangles > 0


def test_postprocessing_parameters_from_reference():
    j = JPost(check_mesh_closed=True, mesh_cleanup=True, mesh_cleanup_snap_dist=0.3,
              interpolate_attributes=["velocity", "pressure"], mesh_smoothing_iters=7,
              quad_max_normal_angle=12.5, mesh_aabb=JAabb((0, 1, 2), (3, 4, 5)),
              mesh_aabb_clamp_vertices=True, output_raw_normals=True)
    t = pt.PostprocessingParameters.from_reference(j)
    assert isinstance(t.mesh_aabb, pt.Aabb3d)
    assert (t.mesh_aabb.min, t.mesh_aabb.max) == ((0.0, 1.0, 2.0), (3.0, 4.0, 5.0))
    for f in j.__dataclass_fields__:
        if f != "mesh_aabb":
            assert getattr(t, f) == getattr(j, f), f
    assert pt.PostprocessingParameters.from_reference(JPost()) == pt.PostprocessingParameters()
