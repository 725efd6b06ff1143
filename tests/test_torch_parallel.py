"""The sharded subdomain route of the port, end to end, on virtual CPU
shards: the dry-run scene of ``__graft_entry__.dryrun_scene`` (a sheet and
a dense clump, over 64 occupied subdomains of uneven occupancy) with
``sharded=True`` on 8 and on 3 shards (uneven slabs) against the port's
one-device run, bit for bit, and against the JAX package's sharded run
(``sharded=True, raster_threshold=0``) in f32: equal counts, vertices
within 1e-4. The f64 comparison is in ``test_torch_parallel_reference.py``."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import __graft_entry__ as graft
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as js

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.parallel import mesh as pm
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


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
    grid = pt.UniformGrid(min=tuple(jgrid.min), cell_size=jgrid.cell_size,
                          n_cells=tuple(jgrid.n_cells))
    return pts, jp, jgrid, pt.Parameters.from_reference(jp), grid


def _run(scene, D, **kw):
    """The port's route on D virtual CPU shards (D = 1: the default list);
    returns the result and a copy of ``LAST_RUN``."""
    pts, _, _, params, grid = scene
    pm.set_devices(["cpu"] * D if D > 1 else None)
    try:
        rec = ts.reconstruct_surface_subdomain_grid(torch.as_tensor(pts), params, grid, **kw)
    finally:
        pm.set_devices(None)
    return rec, dict(ts.LAST_RUN)


@pytest.fixture(scope="module")
def one_device(scene):
    return _run(scene, 1, sharded=True)


@pytest.fixture(scope="module")
def eight(scene):
    return _run(scene, 8, sharded=True)


def test_one_device_list_does_not_shard(one_device):
    rec, run = one_device
    assert not run["sharded"] and not run["sharded_pairs"] and run["devices"] == ["cpu"]
    assert run["B"] >= 64 and rec.mesh.num_triangles > 10000
    assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None


def _same(a, b):
    np.testing.assert_array_equal(a.mesh.vertices, b.mesh.vertices)
    np.testing.assert_array_equal(a.mesh.triangles, b.mesh.triangles)
    np.testing.assert_array_equal(a.particle_densities.numpy(), b.particle_densities.numpy())


def _check_record(run, one_run, D):
    assert run["sharded"] and run["sharded_pairs"] and not run["streamed"]
    assert run["devices"] == ["cpu"] * D and len(run["shards"]) == D
    assert sum(s["B"] for s in run["shards"]) == run["B"] == one_run["B"]
    assert sum(s["n_pairs"] for s in run["shards"]) == run["n_pairs"] == one_run["n_pairs"]
    assert sum(s["splat_chunks"] for s in run["shards"]) == run["splat_chunks"]
    assert all(set(s["stage_s"]) == {"splat", "marching cubes"} for s in run["shards"])
    assert list(run["stage_s"]) == list(one_run["stage_s"])
    assert run["shell_bytes"] == 6 * run["B"] * 9 * 9 * 4
    busy = [s["B"] for s in run["shards"] if s["B"]]
    assert len(busy) >= 3 and max(busy) > min(busy)  # several uneven slabs


def test_eight_shards_equal_one_device_bit_for_bit(eight, one_device):
    _same(eight[0], one_device[0])
    _check_record(eight[1], one_device[1], 8)


def test_three_shards_equal_one_device_and_never_stream(scene, one_device, monkeypatch):
    """Three shards of uneven slabs; the streaming switch is ignored when
    sharded, as in the reference."""
    monkeypatch.setenv(ts.STREAM_ENV, "1")
    rec, run = _run(scene, 3, sharded=True)
    _same(rec, one_device[0])
    _check_record(run, one_device[1], 3)


def test_matches_the_reference_sharded_run_in_f32(scene, eight):
    """The JAX package's sharded route on its 8 devices (its raster splat,
    device stitch): equal counts and vertices within 1e-4."""
    pts, jp, jgrid, _, _ = scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", "0")
        jn.clear_density_plan()
        ref = js.reconstruct_surface_subdomain_grid(pts, jp, jgrid, sharded=True,
                                                    raster_threshold=0)
        assert js.LAST_RUN["sharded_pairs"] and js.LAST_RUN["B"] == eight[1]["B"]
    rec = eight[0]
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == (
        ref.mesh.num_vertices, ref.mesh.num_triangles)
    d, _ = cKDTree(np.asarray(ref.mesh.vertices)).query(rec.mesh.vertices)
    assert d.max() < 1e-4
    np.testing.assert_allclose(rec.particle_densities.numpy(),
                               np.asarray(ref.particle_densities), rtol=2e-5)
