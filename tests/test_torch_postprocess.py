"""The port's post-processing against the JAX package's ``postprocess``:
Laplacian smoothing of vertices and of normals on the device (25
iterations: f32 rtol/atol 1e-5, f64 1e-12; arrays go to CUDA by default, a
tensor stays on its device), and on the host the Moore/Warren cleanup, the
barnacle decimation, tri -> quad conversion and their ``*_with_data``
variants on a reconstructed dam-break mesh (outputs equal), the native
engine against the Python half-edge path, and half-edge collapse legality
on an icosphere built in code."""

import numpy as np
import pytest
import torch

import bench
from splashsurf_tpu import postprocess as jpp
from splashsurf_tpu.mesh import MeshWithData as JMeshWithData
from splashsurf_tpu.mesh import TriMesh3d as JTriMesh3d
from splashsurf_tpu.mesh import vertex_normals as j_vertex_normals

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import native
from splashsurf_tpu_torch import postprocess as tpp
from splashsurf_tpu_torch.halfedge import HalfEdgeTriMesh, IllegalCollapse
from torch_meshes import icosphere, sphere_mc

SMOOTH_TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_laplacian_smoothing(dtype):
    mesh = sphere_mc(21, dtype)
    w = np.random.default_rng(0).uniform(0.0, 1.0, mesh.num_vertices).astype(dtype)
    got = tpp.laplacian_smoothing(mesh.vertices, mesh.triangles, 25, 1.0, w, device="cpu")
    want = np.asarray(jpp.laplacian_smoothing(mesh.vertices, mesh.triangles, 25, 1.0, w))
    assert isinstance(got, np.ndarray) and got.dtype == dtype
    np.testing.assert_allclose(got, want, **SMOOTH_TOL[dtype])
    assert np.abs(got - mesh.vertices).max() > 1e-3  # it moved
    # a tensor stays on its device and comes back as a tensor
    t = tpp.laplacian_smoothing(
        torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.triangles), 25, 1.0, torch.as_tensor(w)
    )
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_smoothing(dtype):
    mesh = sphere_mc(21, dtype)
    n = np.asarray(j_vertex_normals(mesh.vertices, mesh.triangles))
    n = n + np.random.default_rng(1).normal(0, 0.2, n.shape).astype(dtype)
    got = tpp.laplacian_smoothing_normals(n, mesh.triangles, mesh.num_vertices, 25, device="cpu")
    want = np.asarray(jpp.laplacian_smoothing_normals(n, mesh.triangles, mesh.num_vertices, 25))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, **SMOOTH_TOL[dtype])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_smoothing_goes_to_cuda_by_default(monkeypatch):
    mesh = icosphere(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpp.laplacian_smoothing(mesh.vertices, mesh.triangles, 1, 1.0, np.ones(mesh.num_vertices))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpp.laplacian_smoothing_normals(mesh.vertices, mesh.triangles, mesh.num_vertices, 1)


@pytest.fixture(scope="module")
def raw():
    """A raw f64 marching-cubes mesh of a small dam break and its grid; it
    holds double barnacles (no single ones: those are rare in MC meshes)."""
    params = pt.Parameters.new_relative(0.011, 4.0, 1.5, dtype="float64")
    rec = pt.reconstruct_surface(bench.make_dam_break(3000, 0.011, seed=2), params, device="cpu")
    return rec.mesh, rec.grid


def _same_mesh(a, b):
    assert np.asarray(a.vertices).dtype == np.asarray(b.vertices).dtype
    np.testing.assert_array_equal(a.vertices, np.asarray(b.vertices))
    np.testing.assert_array_equal(a.triangles, np.asarray(b.triangles))


def _soup(mesh):
    """Each triangle's corner coordinates (T, 9), rounded to 1e-9 and
    sorted: the mesh independently of its vertex numbering."""
    soup = np.round(np.asarray(mesh.vertices, np.float64)[mesh.triangles].reshape(-1, 9), 9)
    return soup[np.lexsort(soup.T[::-1])]


def _jmesh(mesh):
    return JTriMesh3d(mesh.vertices.copy(), mesh.triangles.copy())


@pytest.mark.parametrize("keep_vertices", [False, True])
@pytest.mark.parametrize("snap", [None, 0.3])
def test_cleanup_and_decimation_equal_the_reference(raw, keep_vertices, snap):
    mesh, grid = raw
    got = tpp.marching_cubes_cleanup(pt.TriMesh3d(mesh.vertices.copy(), mesh.triangles),
                                     grid, snap, keep_vertices=keep_vertices, return_tri_map=True)
    want = jpp.marching_cubes_cleanup(_jmesh(mesh), grid, snap, keep_vertices=keep_vertices,
                                      return_tri_map=True)
    _same_mesh(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].num_triangles < mesh.num_triangles
    if not keep_vertices:
        assert pt.check_mesh_consistency(got[0].vertices, got[0].triangles) is None
    # decimation of the raw mesh (which holds barnacles) and of the cleaned one
    for m in (mesh, got[0]):
        dec = tpp.decimation(m, keep_vertices=keep_vertices, return_tri_map=True)
        dec_j = jpp.decimation(_jmesh(m), keep_vertices=keep_vertices, return_tri_map=True)
        _same_mesh(dec[0], dec_j[0])
        assert dec[1] == dec_j[1]
        np.testing.assert_array_equal(dec[2], dec_j[2])
        assert pt.check_mesh_consistency(dec[0].vertices, dec[0].triangles) is None


def test_decimation_collapses_barnacles(raw):
    mesh, _ = raw
    he = HalfEdgeTriMesh(mesh.vertices, mesh.triangles)
    queue = tpp._collect_single_barnacle_collapses(he) + tpp._collect_double_barnacle_collapses(he)
    assert queue  # the scene holds barnacles, so the comparisons above did work
    dec, _ = tpp.decimation(mesh)
    assert dec.num_vertices < mesh.num_vertices


def test_with_data_variants_equal_the_reference(raw):
    mesh, grid = raw
    g = np.random.default_rng(3)
    vel = g.standard_normal((mesh.num_vertices, 3))
    ids = np.arange(mesh.num_vertices)
    area = g.uniform(size=mesh.num_triangles)

    def pair():
        """The same MeshWithData in both packages, made anew for each call:
        the reference's f64 cleanup moves its input's vertices in place."""
        out = []
        for mod_mesh, mod_md in ((pt.TriMesh3d, pt.MeshWithData), (JTriMesh3d, JMeshWithData)):
            md = mod_md(mod_mesh(mesh.vertices.copy(), mesh.triangles.copy()))
            md.add_point_attribute("velocity", vel)
            md.add_point_attribute("id", ids)
            md.add_cell_attribute("area", area)
            out.append(md)
        return out

    t, j = pair()
    got, want = tpp.marching_cubes_cleanup_with_data(t, grid), jpp.marching_cubes_cleanup_with_data(j, grid)
    t, j = pair()
    got_d, want_d = tpp.decimation_with_data(t), jpp.decimation_with_data(j)
    assert got_d.mesh.num_vertices < mesh.num_vertices
    for a, b in ((got, want), (got_d, want_d)):
        _same_mesh(a.mesh, b.mesh)
        for la, lb in ((a.point_attributes, b.point_attributes), (a.cell_attributes, b.cell_attributes)):
            assert [x.name for x in la] == [x.name for x in lb]
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x.data, np.asarray(y.data))


@pytest.mark.parametrize("limits", [(1.75, 10.0, 135.0), (1.3, 5.0, 120.0)])
def test_quads_equal_the_reference(raw, limits):
    mesh, grid = raw
    cleaned, _ = tpp.marching_cubes_cleanup(pt.TriMesh3d(mesh.vertices.copy(), mesh.triangles), grid)
    ratio, normal, interior = limits
    kw = dict(non_squareness_limit=ratio, normal_angle_limit_rad=np.deg2rad(normal),
              max_interior_angle_rad=np.deg2rad(interior))
    got = tpp.convert_tris_to_quads(cleaned, **kw)
    want = jpp.convert_tris_to_quads(_jmesh(cleaned), **kw)
    assert isinstance(got, pt.MixedTriQuadMesh3d)
    _same_mesh(got, want)
    np.testing.assert_array_equal(got.quads, want.quads)
    assert len(got.quads) > 0 and 2 * len(got.quads) + len(got.triangles) == cleaned.num_triangles


def test_native_engine_equals_the_python_path(raw, monkeypatch):
    assert native.available()
    assert native._LIB.parent.parent.name == "splashsurf_tpu_torch"
    mesh, grid = raw
    n = tpp.marching_cubes_cleanup(pt.TriMesh3d(mesh.vertices.copy(), mesh.triangles), grid)
    nd = tpp.decimation(mesh)
    monkeypatch.setattr(native, "available", lambda: False)
    p = tpp.marching_cubes_cleanup(pt.TriMesh3d(mesh.vertices.copy(), mesh.triangles), grid)
    pd = tpp.decimation(mesh)
    # the cleanup's two paths number the surviving vertices differently but
    # give the same triangles, corner by corner
    assert (n[0].num_vertices, n[0].num_triangles) == (p[0].num_vertices, p[0].num_triangles)
    np.testing.assert_array_equal(_soup(n[0]), _soup(p[0]))
    assert sorted(map(sorted, n[1])) == sorted(map(sorted, p[1]))
    # the decimation's collapse queue comes from the same Python detection
    np.testing.assert_array_equal(nd[0].triangles, pd[0].triangles)
    np.testing.assert_array_equal(nd[0].vertices, pd[0].vertices)
    assert nd[1] == [sorted(m) for m in pd[1]]
    assert native.vertex_ring_sizes(np.array([[0, 1, 2], [0, 2, 3]]), 4).tolist() == [3, 2, 3, 2]


def test_collapse_legality_on_icosphere():
    mesh = icosphere(2)
    he = HalfEdgeTriMesh(mesh.vertices, mesh.triangles)
    assert he.is_collapse_ok(0, 0) == "missing edge"
    collapsed = 0
    for v in range(mesh.num_vertices):
        if collapsed >= 10:
            break
        for u in list(he.adj[v]):
            try:
                he.try_collapse(u, v)
                collapsed += 1
                break
            except IllegalCollapse:
                continue
    assert collapsed == 10
    out, vmap = he.into_parts()
    assert pt.check_mesh_consistency(out.vertices, out.triangles) is None
    assert out.num_vertices == mesh.num_vertices - 10
    assert sum(len(m) for m in vmap) == mesh.num_vertices
    kept, _ = he.into_parts(keep_vertices=True)
    assert kept.num_vertices == mesh.num_vertices
    # a tetrahedron cannot collapse further
    tet = HalfEdgeTriMesh(
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float),
        np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]),
    )
    with pytest.raises(IllegalCollapse, match="tetrahedron"):
        tet.try_collapse(0, 1)
