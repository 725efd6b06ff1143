"""The port's capacity-padded marching cubes (``mc.marching_cubes_padded``,
``MarchingCubesResult``) and ``decode_edge_flat`` against the JAX package's
on the CPU: exact and too-small capacities (true counts past the
capacity, rows equal up to the counts), a global index offset, both float
types, and the edge decoder as the inverse of ``edge_layout``."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import mc as jmc
from splashsurf_tpu.mc import dense as jdense

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import mc as tmc
from splashsurf_tpu_torch.mc import dense as tdense


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(dtype, shape=(19, 17, 21), seed=0):
    """Two overlapping spheres' SDF with noise, so that many cases occur."""
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape), indexing="ij")
    a = 6.0 - np.sqrt((ii - 8) ** 2 + (jj - 8) ** 2 + (kk - 9) ** 2)
    b = 4.5 - np.sqrt((ii - 12) ** 2 + (jj - 9) ** 2 + (kk - 13) ** 2)
    return (np.maximum(a, b) + rng.normal(0, 0.2, shape)).astype(dtype)


def _both(values, caps, index_offset=None):
    grid_min, cs = (0.25, -0.5, 1.0), 0.1
    want = jdense.marching_cubes_padded(
        values, 0.0, np.asarray(grid_min, values.dtype), cs, *caps, index_offset=index_offset)
    got = tmc.marching_cubes_padded(
        torch.as_tensor(values), 0.0, grid_min, cs, *caps, index_offset=index_offset)
    return got, want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("index_offset", [None, (3, 0, 5)])
def test_exact_capacities_equal_the_reference(dtype, index_offset):
    values = _field(dtype)
    nv, nt = tdense._mc_counts(torch.as_tensor(values), 0.0)
    got, want = _both(values, (nv, nt), index_offset)
    assert isinstance(got, tmc.MarchingCubesResult) and got._fields == want._fields
    assert int(got.num_vertices) == int(want.num_vertices) == nv
    assert int(got.num_triangles) == int(want.num_triangles) == nt
    assert got.vertices.shape == (nv, 3) and got.triangles.shape == (nt, 3)
    assert got.vertices.dtype == torch.from_numpy(values).dtype
    np.testing.assert_array_equal(got.triangles.numpy(), np.asarray(want.triangles))
    np.testing.assert_array_equal(got.vertex_edges.numpy(), np.asarray(want.vertex_edges))
    np.testing.assert_allclose(
        got.vertices.numpy(), np.asarray(want.vertices), rtol=0,
        atol=1e-6 if dtype == np.float32 else 1e-14)


@pytest.mark.parametrize("caps", [(8, 8), (100, 3000), (5000, 40)])
def test_small_and_large_capacities_keep_the_true_counts(caps):
    values = _field(np.float32, seed=1)
    nv, nt = tdense._mc_counts(torch.as_tensor(values), 0.0)
    got, want = _both(values, caps)
    assert int(got.num_vertices) == int(want.num_vertices) == nv
    assert int(got.num_triangles) == int(want.num_triangles) == nt
    assert got.vertices.shape == (caps[0], 3) and got.triangles.shape == (caps[1], 3)
    kv, kt = min(nv, caps[0]), min(nt, caps[1])
    np.testing.assert_array_equal(got.triangles.numpy()[:kt], np.asarray(want.triangles)[:kt])
    np.testing.assert_array_equal(got.vertex_edges.numpy()[:kv], np.asarray(want.vertex_edges)[:kv])
    np.testing.assert_allclose(
        got.vertices.numpy()[:kv], np.asarray(want.vertices)[:kv], rtol=0, atol=1e-6)
    # past the counts: the reference's fill
    assert (got.vertex_edges[kv:] == -1).all() and (got.vertices[kv:] == 0).all()
    assert (got.triangles[kt:] == 0).all()


def test_padded_mesh_equals_marching_cubes():
    values = _field(np.float64, seed=2)
    mesh = pt.marching_cubes(values, 0.0, 0.1, (0.25, -0.5, 1.0), device="cpu")
    res = tmc.marching_cubes_padded(
        torch.as_tensor(values), 0.0, (0.25, -0.5, 1.0), 0.1,
        mesh.num_vertices, mesh.num_triangles)
    np.testing.assert_array_equal(res.vertices.numpy(), mesh.vertices)
    np.testing.assert_array_equal(res.triangles.numpy(), mesh.triangles)
    assert pt.check_mesh_consistency(mesh.vertices, mesh.triangles) is None


@pytest.mark.parametrize("n_points", [(5, 6, 7), (19, 17, 21)])
def test_decode_edge_flat_equals_the_reference(n_points):
    _, _, _, total = tdense.edge_layout(n_points)
    ids = np.concatenate([np.arange(-3, total), [0, total - 1]]).astype(np.int32)
    ja, jijk = jdense.decode_edge_flat(ids, n_points)
    ta, tijk = tmc.decode_edge_flat(torch.as_tensor(ids), n_points)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tijk.numpy(), np.asarray(jijk))


def test_decode_edge_flat_inverts_the_edge_layout():
    values = _field(np.float32, seed=3)
    n_points = values.shape
    res = tmc.marching_cubes_padded(torch.as_tensor(values), 0.0, (0, 0, 0), 1.0, 4096, 8192)
    nv = int(res.num_vertices)
    edges = res.vertex_edges[:nv]
    axis, ijk = tmc.decode_edge_flat(edges, n_points)
    shapes, strides, offsets, _ = tdense.edge_layout(n_points)
    again = torch.as_tensor(offsets)[axis] + sum(
        ijk[:, d] * torch.as_tensor([s[d] for s in strides])[axis] for d in range(3))
    np.testing.assert_array_equal(again.numpy(), edges.numpy())
    for a in range(3):
        sel = ijk[axis == a]
        assert (sel >= 0).all() and (sel < torch.as_tensor(shapes[a])).all()
    # each vertex lies on its decoded edge: base point plus t along the axis
    base = ijk.to(torch.float32)
    off = res.vertices[:nv] - base
    onaxis = off.gather(1, axis[:, None]).squeeze(1)
    assert (onaxis >= 0).all() and (onaxis <= 1).all()
    off.scatter_(1, axis[:, None], 0.0)
    assert (off == 0).all()


def test_mc_reexports_the_reference_names():
    for name in jmc.__all__:
        assert hasattr(tmc, name), name
    assert tmc.__all__ == jmc.__all__
