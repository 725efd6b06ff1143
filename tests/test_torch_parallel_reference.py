"""The sharded subdomain route of the port against the JAX package's in
f64, on the dry-run scene of ``__graft_entry__.dryrun_scene``: 8 virtual
CPU shards on both sides, the same triangle soup; and the replicated
decomposition split into slabs (``SPLASHSURF_TPU_SHARD_DECOMP=0``) gives the
sharded decomposition's mesh bit for bit, on a small dam break."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as js

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.parallel import mesh as pm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    pts, jp, jgrid = graft.dryrun_scene()
    jp = jp.try_convert("float64")
    grid = pt.UniformGrid(min=tuple(jgrid.min), cell_size=jgrid.cell_size,
                          n_cells=tuple(jgrid.n_cells))
    return pts.astype(np.float64), jp, jgrid, pt.Parameters.from_reference(jp), grid


def _run(scene, D=8, **kw):
    pts, _, _, params, grid = scene
    pm.set_devices(["cpu"] * D if D > 1 else None)
    try:
        rec = ts.reconstruct_surface_subdomain_grid(torch.as_tensor(pts), params, grid, **kw)
    finally:
        pm.set_devices(None)
    return rec, dict(ts.LAST_RUN)


@pytest.fixture(scope="module")
def sharded(scene):
    return _run(scene, sharded=True)


def _soup(mesh, cell_size):
    tri = np.round(np.asarray(mesh.vertices)[np.asarray(mesh.triangles)] / cell_size, 3)
    return sorted(tuple(sum(sorted(map(tuple, t)), ())) for t in tri)


def test_matches_the_reference_sharded_run_in_f64(scene, sharded):
    pts, jp, jgrid, _, grid = scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", "0")
        jn.clear_density_plan()
        ref = js.reconstruct_surface_subdomain_grid(pts, jp, jgrid, sharded=True,
                                                    raster_threshold=0)
        assert js.LAST_RUN["sharded_pairs"]
    rec, run = sharded
    assert run["sharded"] and run["sharded_pairs"] and run["B"] == js.LAST_RUN["B"] >= 64
    assert rec.mesh.vertices.dtype == np.float64
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == (
        ref.mesh.num_vertices, ref.mesh.num_triangles)
    assert _soup(rec.mesh, grid.cell_size) == _soup(ref.mesh, grid.cell_size)
    np.testing.assert_allclose(rec.particle_densities.numpy(),
                               np.asarray(ref.particle_densities), rtol=1e-10)


def test_replicated_decomposition_gives_the_same_mesh(monkeypatch):
    """``SPLASHSURF_TPU_SHARD_DECOMP=0``: one device decomposes and the pairs
    are split into the shards' slabs; the mesh is the sharded
    decomposition's and the one-device mesh, bit for bit (a 3,000-particle
    dam break in 16-cell subdomains, f64, 4 shards)."""
    pts = bench.make_dam_break(3000, 0.011, seed=1).astype(np.float64)
    params = pt.Parameters.new_relative(
        0.011, 4.0, 1.5, grid_decomposition=pt.GridDecompositionParameters(16, auto_disable=False)
    ).try_convert("float64")
    grid = pt.grid_for_reconstruction(torch.as_tensor(pts), params.particle_radius,
                                      params.compact_support_radius, params.cube_size)
    scene = (pts, None, None, params, grid)
    one, _ = _run(scene, 1)
    routed, run1 = _run(scene, 4, sharded=True)
    assert run1["sharded"] and run1["sharded_pairs"]
    monkeypatch.setenv(ts.SHARD_DECOMP_ENV, "0")
    split, run0 = _run(scene, 4, sharded=True)
    assert run0["sharded"] and not run0["sharded_pairs"]
    assert len([s for s in run0["shards"] if s["B"]]) >= 2
    for rec in (split, one):
        np.testing.assert_array_equal(rec.mesh.vertices, routed.mesh.vertices)
        np.testing.assert_array_equal(rec.mesh.triangles, routed.mesh.triangles)
