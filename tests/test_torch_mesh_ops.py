"""The port's mesh ops against the JAX package's ``mesh`` module on meshes
built in code (an icosphere, a marching-cubes sphere): face and vertex
normals and triangle areas (f64 to 1e-12, f32 to rtol 2e-5 / atol 1e-5;
numpy in, numpy out, on CUDA unless ``device=`` says otherwise; a tensor
stays on its device), vertex-vertex and
vertex-cell connectivity (equal), and ``MeshWithData``'s keep / clamp /
remap (equal)."""

import numpy as np
import pytest
import torch

import splashsurf_tpu.mesh as jm
from splashsurf_tpu.aabb import Aabb3d as JAabb

import splashsurf_tpu_torch as pt
import splashsurf_tpu_torch.mesh as tm
from torch_meshes import icosphere, sphere_mc

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=2e-5, atol=1e-5)


def _jitter(mesh, dtype, seed=0):
    """The mesh with its vertices moved a little off the sphere, so that
    the areas and normals vary from face to face."""
    g = np.random.default_rng(seed)
    v = mesh.vertices * (1.0 + 0.05 * g.standard_normal((mesh.num_vertices, 1)))
    return pt.TriMesh3d(v.astype(dtype), mesh.triangles)


MESHES = {"icosphere": lambda: icosphere(3), "mc_sphere": lambda: sphere_mc(21)}


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_normals_and_areas(name, dtype):
    mesh = _jitter(MESHES[name](), dtype)
    tol = F64 if dtype == np.float64 else F32
    v, t = mesh.vertices, mesh.triangles
    for normalized in (True, False):
        got = tm.face_normals(v, t, normalized=normalized, device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == dtype
        np.testing.assert_allclose(got, np.asarray(jm.face_normals(v, t, normalized=normalized)), **tol)
    got = tm.vertex_normals(v, t, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == dtype
    np.testing.assert_allclose(got, np.asarray(jm.vertex_normals(v, t)), **tol)
    np.testing.assert_allclose(tm.triangle_areas(v, t, device="cpu"), np.asarray(jm.triangle_areas(v, t)), **tol)
    np.testing.assert_allclose(mesh.vertex_normals(device="cpu"), got, rtol=0, atol=0)


def test_tensors_stay_on_their_device(monkeypatch):
    mesh = icosphere(1)
    v, t = torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.triangles)
    out = tm.vertex_normals(v, t)
    assert isinstance(out, torch.Tensor) and out.device == v.device
    np.testing.assert_array_equal(out.numpy(), tm.vertex_normals(mesh.vertices, mesh.triangles, device="cpu"))
    assert isinstance(tm.face_normals(v, t), torch.Tensor)
    assert isinstance(tm.triangle_areas(v, t), torch.Tensor)
    with pytest.raises(ValueError, match="device"):
        tm.vertex_normals(v, t, device="meta")
    # arrays go to CUDA by default, and raise where it is absent
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tm.vertex_normals, tm.face_normals, tm.triangle_areas):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(mesh.vertices, mesh.triangles)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.vertex_normals()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_connectivity(name):
    mesh = MESHES[name]()
    nv = mesh.num_vertices
    off_t, nb_t = tm.vertex_vertex_connectivity_csr(mesh.triangles, nv)
    off_j, nb_j = jm.vertex_vertex_connectivity_csr(mesh.triangles, nv)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(nb_t, nb_j)
    for a, b in zip(tm.vertex_cell_connectivity(mesh.triangles, nv),
                    jm.vertex_cell_connectivity(mesh.triangles, nv)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.edge_information(mesh.triangles), jm.edge_information(mesh.triangles)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    conn = mesh.vertex_vertex_connectivity()
    assert isinstance(conn, tm.VertexVertexConnectivity) and len(conn) == nv
    assert conn.copy_connectivity() == jm.TriMesh3d(mesh.vertices, mesh.triangles).vertex_vertex_connectivity().copy_connectivity()


def _pair(mesh, seed=1):
    """The same MeshWithData in both packages, with a vector and an integer
    point attribute and a cell attribute."""
    g = np.random.default_rng(seed)
    vel = g.standard_normal((mesh.num_vertices, 3))
    ids = np.arange(mesh.num_vertices, dtype=np.int64)
    area = g.uniform(size=mesh.num_triangles)
    out = []
    for mod in (tm, jm):
        md = mod.MeshWithData(mod.TriMesh3d(mesh.vertices.copy(), mesh.triangles.copy()))
        md.add_point_attribute("velocity", vel)
        md.add_point_attribute("id", ids)
        md.add_cell_attribute("area", area)
        out.append(md)
    return out


def _same(a, b):
    np.testing.assert_array_equal(a.mesh.vertices, np.asarray(b.mesh.vertices))
    np.testing.assert_array_equal(a.mesh.triangles, np.asarray(b.mesh.triangles))
    for la, lb in ((a.point_attributes, b.point_attributes), (a.cell_attributes, b.cell_attributes)):
        assert [x.name for x in la] == [x.name for x in lb]
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x.data, np.asarray(y.data))


def test_mesh_with_data_keep_clamp_remap():
    mesh = icosphere(2)
    t, j = _pair(mesh)
    assert t.mesh_type.value == j.mesh_type.value == "Tri3d"
    g = np.random.default_rng(2)
    cells = np.sort(g.choice(mesh.num_triangles, mesh.num_triangles // 3, replace=False))
    _same(t.keep_cells(cells), j.keep_cells(cells))
    vmask = g.uniform(size=mesh.num_vertices) < 0.7
    _same(t.keep_vertices(vmask), j.keep_vertices(vmask))
    for clamp in (True, False):
        for keep in (True, False):
            _same(
                t.par_clamp_with_aabb(pt.Aabb3d((-0.5, -2, -2), (0.6, 2, 2)), clamp, keep),
                j.par_clamp_with_aabb(JAabb((-0.5, -2, -2), (0.6, 2, 2)), clamp, keep),
            )
    vmap = g.permutation(mesh.num_vertices)[: mesh.num_vertices // 2]
    new = tm.TriMesh3d(mesh.vertices[vmap], np.zeros((0, 3), np.int32))
    _same(t.remap_through_vertex_map(new, vmap),
          j.remap_through_vertex_map(jm.TriMesh3d(new.vertices, new.triangles), vmap))
    # the plain mesh ops
    m_t, m_j = tm.TriMesh3d(mesh.vertices, mesh.triangles), jm.TriMesh3d(mesh.vertices, mesh.triangles)
    for a, b in ((m_t.keep_cells(cells), m_j.keep_cells(cells)),
                 (m_t.keep_vertices(vmask), m_j.keep_vertices(vmask)),
                 (m_t.par_clamp_with_aabb(pt.Aabb3d((-0.5, -2, -2), (0.6, 2, 2))),
                  m_j.par_clamp_with_aabb(JAabb((-0.5, -2, -2), (0.6, 2, 2))))):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.triangles, b.triangles)
    with pytest.raises(ValueError):
        t.add_point_attribute("short", np.zeros(3))
    with pytest.raises(TypeError):
        tm.MeshWithData(tm.MixedTriQuadMesh3d(mesh.vertices, mesh.triangles, np.zeros((0, 4), np.int32))).keep_cells(cells)
