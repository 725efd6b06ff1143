"""The port's pysplashsurf-parity surface: every name of the JAX package's
``__all__`` and every submodule it loads on access resolves on
``splashsurf_tpu_torch`` to the port's counterpart, ``parallel`` with the
reference's ``__all__``; the debug outputs
(``density_map_to_hex_mesh``) and the meshio BGEO plugin give the JAX
package's results; and the thin pysplashsurf methods behave as the JAX
package's parity tests hold them, on the CPU."""

import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import splashsurf_tpu as st
from splashsurf_tpu import meshio_bgeo as jbgeo
from splashsurf_tpu.mesh import density_map_to_hex_mesh as ref_hex

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import meshio_bgeo as tbgeo
from splashsurf_tpu_torch.io import bgeo as tbgeo_io
from splashsurf_tpu_torch.mesh import HexMesh3d, PointCloud3d, density_map_to_hex_mesh

# the submodules the JAX package's ``__getattr__`` loads on access
REFERENCE_SUBMODULES = (
    "io", "mesh", "profiling", "postprocess", "pipeline", "mc", "neighbors", "density",
    "subdomains", "sph_interpolation", "sequence", "parallel", "cli", "studio",
)
NOT_PORTED: set = set()
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", st.__all__)
def test_reference_name_resolves_on_the_port(name):
    ref = getattr(st, name)
    got = getattr(pt, name)
    if isinstance(ref, types.ModuleType):
        assert got.__name__ == ref.__name__.replace("splashsurf_tpu", "splashsurf_tpu_torch", 1)
        return
    assert got.__module__.split(".")[0] == "splashsurf_tpu_torch", (name, got.__module__)
    assert got.__module__.split(".")[1:] == ref.__module__.split(".")[1:], name
    assert got.__qualname__ == ref.__qualname__, name
    assert name in pt.__all__


@pytest.mark.parametrize("name", REFERENCE_SUBMODULES)
def test_reference_submodule_resolves_on_the_port(name):
    assert isinstance(getattr(st, name), types.ModuleType)
    if name in NOT_PORTED:
        with pytest.raises(AttributeError, match=name):
            getattr(pt, name)
        return
    mod = getattr(pt, name)
    assert isinstance(mod, types.ModuleType)
    assert mod.__name__ == f"splashsurf_tpu_torch.{name}"


def test_parallel_loads_lazily_with_the_reference_names():
    from splashsurf_tpu import parallel as jpar

    probe = (
        "import sys, splashsurf_tpu_torch as pt; "
        "assert 'splashsurf_tpu_torch.parallel' not in sys.modules; "
        "pt.parallel; assert 'splashsurf_tpu_torch.parallel' in sys.modules; "
        "assert 'splashsurf_tpu' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=ROOT)
    mod = pt.parallel
    assert mod.__all__ == jpar.__all__ == [
        "make_mesh", "sharded_levelset_step", "sharded_reconstruction_demo"]
    for name in jpar.__all__:
        assert callable(getattr(mod, name))
        assert getattr(mod, name).__module__ == "splashsurf_tpu_torch.parallel.mesh"


def test_unknown_names_raise():
    with pytest.raises(AttributeError, match="no_such_name"):
        pt.no_such_name


@pytest.mark.parametrize("threshold", [0.5, 0.9, 2.0])
def test_density_map_to_hex_mesh_matches_the_reference(threshold):
    rng = np.random.default_rng(7)
    levelset = rng.uniform(0, 1, (7, 8, 9)).astype(np.float32)
    grid = pt.UniformGrid(min=(0.1, -0.2, 0.3), cell_size=0.05, n_cells=(6, 7, 8))
    jgrid = st.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    got = density_map_to_hex_mesh(levelset, grid, threshold)
    want = ref_hex(levelset, jgrid, threshold)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    hexes = HexMesh3d(vertices=got[0], cells=got[1])
    assert hexes.num_vertices == len(got[0]) == len(np.unique(got[1]))
    assert PointCloud3d(vertices=got[0]).num_vertices == hexes.num_vertices


def test_density_map_to_hex_mesh_shares_corners():
    grid = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=1.0, n_cells=(3, 3, 3))
    ls = np.zeros((4, 4, 4), np.float32)
    ls[1, 1, 1] = 2.0
    ls[2, 1, 1] = 3.0
    verts, cells, vals = density_map_to_hex_mesh(ls, grid, 1.0)
    assert cells.shape == (2, 8)
    assert len(verts) == 12  # two adjacent hexes share 4 corners
    assert sorted(vals.tolist()) == [2.0, 3.0]


class _StubMesh:
    def __init__(self, points, cells, point_data=None):
        self.points = points
        self.cells = cells
        self.point_data = point_data or {}


@pytest.fixture
def stub_meshio(monkeypatch):
    """``meshio`` is not installed: a stub module with its ``Mesh``."""
    stub = types.ModuleType("meshio")
    stub.Mesh = _StubMesh
    monkeypatch.setitem(sys.modules, "meshio", stub)
    return stub


def test_read_bgeo_matches_the_reference(stub_meshio, tmp_path):
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (57, 3)).astype(np.float32)
    attrs = {"velocity": rng.normal(size=(57, 3)).astype(np.float32),
             "density": rng.uniform(900, 1100, 57).astype(np.float32)}
    path = str(tmp_path / "p.bgeo")
    tbgeo_io.write_particles_bgeo(path, pos, attrs)
    got, want = tbgeo.read_bgeo(path), jbgeo.read_bgeo(path)
    assert got.points.dtype == want.points.dtype == np.float64
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.points, pos.astype(np.float64))
    assert [c[0] for c in got.cells] == [c[0] for c in want.cells] == ["vertex"]
    np.testing.assert_array_equal(got.cells[0][1], want.cells[0][1])
    assert sorted(got.point_data) == sorted(want.point_data) == sorted(attrs)
    for k in attrs:
        np.testing.assert_array_equal(got.point_data[k], want.point_data[k])
    # and back: the port's writer, the reference's reader
    again = str(tmp_path / "q.bgeo")
    tbgeo.write_bgeo(again, got)
    back = jbgeo.read_bgeo(again)
    np.testing.assert_array_equal(back.points, want.points)
    for k in attrs:
        np.testing.assert_array_equal(back.point_data[k], want.point_data[k])


def test_register_without_meshio_helpers(stub_meshio):
    assert tbgeo.register() is jbgeo.register() is False


@pytest.fixture(scope="module")
def cloud():
    return np.random.default_rng(0).uniform(0, 1, (1500, 3)).astype(np.float32)


def test_neighborhood_lists_type(cloud):
    nl = pt.neighborhood_search_spatial_hashing_parallel(torch.as_tensor(cloud), 0.1)
    assert isinstance(nl, pt.NeighborhoodLists)
    assert len(nl) == len(cloud)
    assert isinstance(nl[0], np.ndarray)
    assert isinstance(nl.get_neighborhood_lists()[0], list)
    assert nl.offsets.shape == (len(cloud) + 1,) and nl.offsets[-1] == len(nl.indices)


def test_mesh_type_and_connectivity(cloud):
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    mesh = pt.reconstruct_surface(cloud[:400] * 0.02, p, device="cpu").mesh
    np.testing.assert_allclose(
        mesh.vertex_normals_parallel(device="cpu"), mesh.vertex_normals(device="cpu")
    )
    vv = mesh.vertex_vertex_connectivity()
    assert isinstance(vv, pt.VertexVertexConnectivity)
    copied = vv.copy_connectivity()
    assert isinstance(copied[0], list) and len(copied) == len(vv)
    taken = vv.take_connectivity()
    assert len(taken) == len(copied) and len(vv) == 0
    assert pt.MeshWithData(mesh=mesh).mesh_type == pt.MeshType.Tri3d


def test_interpolate_quantity_dispatch(cloud):
    pts = cloud[:400] * 0.02
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    rec = pt.reconstruct_surface(pts, p, device="cpu")
    rho = rec.particle_densities.numpy()
    si = pt.SphInterpolator(pts, rho, p.particle_rest_mass, p.compact_support_radius, device="cpu")
    q = np.asarray(rec.mesh.vertices)[:8]
    s = si.interpolate_quantity(rho, q)
    v = si.interpolate_quantity(np.tile(rho[:, None], (1, 3)), q)
    assert s.shape == (8,) and v.shape == (8, 3)
    np.testing.assert_allclose(v[:, 0], s, rtol=1e-6)


@pytest.fixture(scope="module")
def small_mesh(cloud):
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    return pt.reconstruct_surface(cloud[:400] * 0.02, p, device="cpu")


def _ref_mesh(mesh):
    return st.TriMesh3d(vertices=mesh.vertices.copy(), triangles=mesh.triangles.copy())


@pytest.mark.parametrize(
    "name", ["barnacle_decimation", "marching_cubes_cleanup", "convert_tris_to_quads"]
)
def test_host_aliases_match_the_reference(name, small_mesh):
    """The aliased host edits give their reference namesakes' meshes."""
    rec = small_mesh
    args = ()
    ref_args = ()
    if name == "marching_cubes_cleanup":
        g = rec.grid
        args = (g,)
        ref_args = (st.UniformGrid(min=g.min, cell_size=g.cell_size, n_cells=g.n_cells),)
    got = getattr(pt, name)(rec.mesh, *args)
    want = getattr(st, name)(_ref_mesh(rec.mesh), *ref_args)
    if name == "convert_tris_to_quads":
        assert isinstance(got, pt.MixedTriQuadMesh3d)
        assert 2 * len(got.get_quads()) + len(got.get_triangles()) == rec.mesh.num_triangles
        pairs = ((got.vertices, want.vertices), (got.get_triangles(), want.get_triangles()),
                 (got.get_quads(), want.get_quads()))
    else:
        (gm, gmap), (wm, wmap) = got, want
        assert isinstance(gm, pt.TriMesh3d) and gmap == wmap
        assert pt.check_mesh_consistency(gm.vertices, gm.triangles) is None
        pairs = ((gm.vertices, wm.vertices), (gm.triangles, wm.triangles))
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_smoothing_aliases_match_the_reference(small_mesh):
    mesh = small_mesh.mesh
    weights = np.linspace(0.5, 1.0, mesh.num_vertices).astype(np.float32)
    got = pt.laplacian_smoothing_parallel(mesh.vertices, mesh.triangles, 3, 0.5, weights, device="cpu")
    want = st.laplacian_smoothing_parallel(mesh.vertices, mesh.triangles, 3, 0.5, weights)
    assert not np.array_equal(got, mesh.vertices)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    normals = mesh.vertex_normals(device="cpu")
    got = pt.laplacian_smoothing_normals_parallel(normals, mesh.triangles, mesh.num_vertices, 2, device="cpu")
    want = st.laplacian_smoothing_normals_parallel(normals, mesh.triangles, mesh.num_vertices, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
