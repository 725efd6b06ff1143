"""The port's neighbour search (``neighbors.neighborhood_search_spatial_hashing_parallel``
and its helpers) against the JAX package's and the O(N^2) oracle, and
``global_neighborhood_list=True`` through ``reconstruct_surface`` on every
route: the dense route with the legacy and the cell-raster densities, the
subdomain route and the slab route. Lists are compared as per-particle
sorted sets (the order within a list follows the bin lattice)."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.aabb import Aabb3d as JAabb

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.ops import slab_sweep as tslab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n=1500, clump=0):
    """A uniform cloud in a 0.3 m box, plus ``clump`` particles within 1 cm
    of one of them (a bin far fuller than the rest)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 0.3, (n, 3))
    return np.concatenate([pts, pts[7] + rng.uniform(-0.01, 0.01, (clump, 3))])


CLOUDS = {"uniform": _cloud(0), "dense clump": _cloud(1, clump=200)}
RADIUS = 0.03


def _sets(lists):
    return [sorted(int(i) for i in a) for a in lists]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(CLOUDS))
def test_lists_match_the_reference(name, dtype):
    pts = CLOUDS[name].astype(dtype)
    ref = jn.neighborhood_search_spatial_hashing_parallel(pts, RADIUS)
    got = pt.neighborhood_search_spatial_hashing_parallel(pts, RADIUS, device="cpu")
    assert isinstance(got, pt.NeighborhoodLists) and len(got) == len(pts)
    assert all(a.dtype == np.int32 for a in got)
    assert _sets(got) == _sets(ref)
    s, r = pt.compute_neighborhood_stats(got), jn.compute_neighborhood_stats(ref)
    np.testing.assert_array_equal(s.histogram, r.histogram)
    assert (s.particles_with_neighbors, s.max_neighbors, s.avg_neighbors) == (
        r.particles_with_neighbors, r.max_neighbors, r.avg_neighbors
    )
    if name == "dense clump":
        assert s.max_neighbors > 150  # bins far past the 8-slot tables
    naive = tn.neighborhood_search_naive(pts, RADIUS)
    assert _sets(got) == _sets(naive)


def test_both_call_forms_and_tensor_input():
    pts = CLOUDS["uniform"]
    want = _sets(pt.neighborhood_search_spatial_hashing_parallel(pts, RADIUS, device="cpu"))
    # the reference's (positions, domain, search_radius) form: a lattice on
    # a domain larger than the particles
    domain = pt.Aabb3d((-0.1, -0.2, -0.05), (0.4, 0.35, 0.5))
    got = pt.neighborhood_search_spatial_hashing_parallel(
        torch.as_tensor(pts), domain, RADIUS
    )
    assert _sets(got) == want
    ref = jn.neighborhood_search_spatial_hashing_parallel(
        pts, JAabb(np.asarray(domain.min), np.asarray(domain.max)), RADIUS
    )
    assert _sets(ref) == want
    with pytest.raises(TypeError, match="search_radius"):
        pt.neighborhood_search_spatial_hashing_parallel(pts, domain, device="cpu")


def test_chunking_changes_nothing(monkeypatch):
    pts = torch.as_tensor(CLOUDS["dense clump"])
    whole = pt.neighborhood_search_spatial_hashing_parallel(pts, RADIUS)
    grid = tn.BinGrid.for_domain(pts.min(0).values.numpy(), pts.max(0).values.numpy(), RADIUS)
    cl = tn.build_cell_list(pts, grid)
    cap = tn._round_up(tn.max_bin_occupancy(cl))
    counts = tn.neighbor_counts_and_distsq(pts, grid, cl, RADIUS, cap)
    padded, full = tn.neighbor_lists_padded(pts, grid, cl, RADIUS, cap, 256)
    # three queries per chunk
    monkeypatch.setattr(tn, "NEIGHBOR_CHUNK_SLOTS", 27 * cap * 3)
    chunked = pt.neighborhood_search_spatial_hashing_parallel(pts, RADIUS)
    assert len(chunked) == len(whole)
    assert all(np.array_equal(a, b) for a, b in zip(chunked, whole))
    assert torch.equal(tn.neighbor_counts_and_distsq(pts, grid, cl, RADIUS, cap), counts)
    p2, f2 = tn.neighbor_lists_padded(pts, grid, cl, RADIUS, cap, 256)
    assert torch.equal(p2, padded) and torch.equal(f2, full)
    # the padded form, through to_csr, is the ragged one
    offsets, indices = tn.to_csr(padded.numpy(), full.numpy())
    np.testing.assert_array_equal(offsets, whole.offsets)
    np.testing.assert_array_equal(indices, whole.indices)
    back = pt.NeighborhoodLists.from_csr(whole.offsets, whole.indices)
    assert back.get_neighborhood_lists() == whole.get_neighborhood_lists()


def test_max_neighbors_keeps_each_list_s_first_entries():
    pts = CLOUDS["dense clump"]
    full = pt.neighborhood_search_spatial_hashing_parallel(pts, RADIUS, device="cpu")
    cut = pt.neighborhood_search_spatial_hashing_parallel(
        pts, RADIUS, max_neighbors=20, device="cpu"
    )
    assert max(len(a) for a in full) > 20
    assert all(np.array_equal(c, f[:20]) for c, f in zip(cut, full))
    ref = jn.neighborhood_search_spatial_hashing_parallel(pts, RADIUS, max_neighbors=20)
    assert [len(a) for a in ref] == [len(a) for a in cut]


@pytest.fixture(scope="module")
def dam():
    return bench.make_dam_break(1500, 0.011, seed=4)


@pytest.fixture(scope="module")
def reference_lists(dam):
    """The JAX package's lists as each of its routes fills them: the search
    within the compact support radius (global_pipeline.py:352-357,
    subdomains.py:2544-2549, ops/slab_sweep.py:495-499)."""
    jp = st.Parameters.new_relative(0.011, 4.0, 1.5)
    return _sets(jn.neighborhood_search_spatial_hashing_parallel(dam, jp.compact_support_radius))


ROUTES = {
    "dense": ({}, {}),
    "cell-raster": ({"SPLASHSURF_TPU_DENSITY_CELLRASTER": "1cpu"}, {}),
    "subdomain": ({}, dict(grid_decomposition=pt.GridDecompositionParameters(16, auto_disable=False))),
    "slab": ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000",
              "SPLASHSURF_TPU_SLAB_CELLS_BUDGET": "4000"},
             dict(grid_decomposition=pt.GridDecompositionParameters(16))),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_fills_the_lists(dam, reference_lists, route, monkeypatch):
    env, kw = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with_lists = pt.Parameters.new_relative(
        0.011, 4.0, 1.5, dtype="float64", global_neighborhood_list=True, **kw
    )
    tslab.LAST_RUN.clear()
    rec = pt.reconstruct_surface(dam, with_lists, device="cpu")
    took = {
        "dense": rec.subdomain_grid is None and tn.LAST_GATE.get("kind") != "cellraster",
        "cell-raster": tn.LAST_GATE.get("kind") == "cellraster",
        "subdomain": rec.subdomain_grid is not None,
        "slab": tslab.LAST_RUN.get("n_slabs", 0) > 1,
    }
    assert took[route]
    assert isinstance(rec.particle_neighbors, pt.NeighborhoodLists)
    assert _sets(rec.particle_neighbors) == reference_lists
    plain = pt.reconstruct_surface(
        dam, pt.Parameters.new_relative(0.011, 4.0, 1.5, dtype="float64", **kw), device="cpu"
    )
    assert plain.particle_neighbors is None
    np.testing.assert_array_equal(rec.mesh.triangles, plain.mesh.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, plain.mesh.vertices)


def test_a_sequence_yields_lists_and_mesh_together(dam):
    params = pt.Parameters.new_relative(0.011, 4.0, 1.5, global_neighborhood_list=True)
    frames = [dam, dam + 1e-4, dam[:1000]]
    seq = list(pt.reconstruct_sequence(frames, params, device="cpu"))
    for frame, rec in zip(frames, seq):
        assert rec.mesh is not None and rec.mesh.num_triangles > 0
        assert len(rec.particle_neighbors) == len(frame)
        one = pt.reconstruct_surface(frame, params, device="cpu")
        assert _sets(rec.particle_neighbors) == _sets(one.particle_neighbors)
        np.testing.assert_array_equal(rec.mesh.triangles, one.mesh.triangles)
