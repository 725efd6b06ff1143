"""The encoded mesh pull on the subdomain route
(``SPLASHSURF_TPU_SUB_ENCODED_PULL=1``, read per call by both packages):
owned-point streams per subdomain, regathered into the reference's run
order, one copy, one host decode.

- Resident, streamed and on 4 virtual CPU shards, the port gives the JAX
  package's resident encoded mesh (its streamed and sharded runs are its
  resident mesh by construction): the same triangle list, vertices within
  1e-4 (f32) / 1e-9 (f64); streamed and sharded equal the port's resident
  mesh bit for bit.
- With u16 t the mesh keeps the exact pull's triangles, vertices within
  cell_size / 65535 * 1.01.
- The stitch (the port's default) and the encoded pull give the same
  surface; ``enable_profile_sync`` changes the clock, not the mesh.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as js
from splashsurf_tpu.params import GridDecompositionParameters as JGrid
from splashsurf_tpu.reconstruction import _bucket_grid, grid_for_reconstruction

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import native
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.parallel import mesh as pm
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.05
ENC = "SPLASHSURF_TPU_SUB_ENCODED_PULL"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    for k in (ENC, ts.STREAM_ENV, "SPLASHSURF_TPU_PULL_QUANT"):
        monkeypatch.delenv(k, raising=False)
    yield
    ts.enable_profile_sync(False)


def _setup(dtype):
    pts = bench.make_canyon(3000, RADIUS, seed=2).astype(dtype)
    jp = st.Parameters.new_relative(
        RADIUS, 4.0, 1.5, grid_decomposition=JGrid(16, auto_disable=False)
    ).try_convert(dtype)
    grid = _bucket_grid(
        grid_for_reconstruction(pts, jp.particle_radius, jp.compact_support_radius, jp.cube_size)
    )
    return pts, jp, grid


@pytest.fixture(scope="module")
def reference():
    """The JAX package's resident encoded meshes (its raster path, the
    default u16 t in f32), per dtype."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv(ENC, "1")
    mp.delenv("SPLASHSURF_TPU_PULL_QUANT", raising=False)
    try:
        for dtype in ("float64", "float32"):
            pts, jp, grid = _setup(dtype)
            jn.clear_density_plan()
            out[dtype] = js.reconstruct_surface_subdomain_grid(pts, jp, grid, raster_threshold=0)
    finally:
        mp.undo()
    return out


def _port(dtype, D=1):
    pts, jp, grid = _setup(dtype)
    tgrid = pt.UniformGrid(min=tuple(grid.min), cell_size=grid.cell_size,
                           n_cells=tuple(grid.n_cells))
    pm.set_devices(["cpu"] * D if D > 1 else None)
    try:
        rec = ts.reconstruct_surface_subdomain_grid(
            torch.as_tensor(pts), pt.Parameters.from_reference(jp), tgrid,
            sharded=True if D > 1 else None,
        )
    finally:
        pm.set_devices(None)
    return rec, dict(ts.LAST_RUN)


def _same_as_reference(rec, ref, dtype):
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    v, t = rec.mesh.vertices, rec.mesh.triangles
    assert v.dtype == np.dtype(dtype) and t.dtype == np.int32
    assert t.shape == rt.shape and t.shape[0] > 1000
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9 if dtype == "float64" else 1e-4)
    assert pt.check_mesh_consistency(v, t) is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resident_matches_the_reference(reference, dtype, monkeypatch):
    monkeypatch.setenv(ENC, "1")
    before = dict(native.DECODE_STATS)
    rec, run = _port(dtype)
    assert not run["streamed"] and not run["sharded"] and run["B"] == js.LAST_RUN["B"] > 4
    assert {"pull", "decode"} <= set(run["stage_s"]) and "stitch" not in run["stage_s"]
    assert run["pull_bytes"] > 0
    engine = "native" if dtype == "float32" else "numpy"
    assert native.DECODE_STATS[engine] == before[engine] + 1
    _same_as_reference(rec, reference[dtype], dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streamed_is_the_resident_mesh(reference, dtype, monkeypatch):
    monkeypatch.setenv(ENC, "1")
    resident, _ = _port(dtype)
    monkeypatch.setenv(ts.STREAM_ENV, "1")
    rec, run = _port(dtype)
    assert run["streamed"] and run["splat_chunks"] >= 1
    np.testing.assert_array_equal(rec.mesh.triangles, resident.mesh.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, resident.mesh.vertices)
    _same_as_reference(rec, reference[dtype], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_four_shards_give_the_resident_mesh(reference, dtype, monkeypatch):
    monkeypatch.setenv(ENC, "1")
    resident, _ = _port(dtype)
    rec, run = _port(dtype, D=4)
    assert run["sharded"] and len(run["devices"]) == 4
    assert sum(1 for s in run["shards"] if s["B"] > 0) >= 2
    np.testing.assert_array_equal(rec.mesh.triangles, resident.mesh.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, resident.mesh.vertices)
    _same_as_reference(rec, reference[dtype], dtype)


def test_quantized_keeps_the_exact_triangles(monkeypatch):
    monkeypatch.setenv(ENC, "1")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL_QUANT", "0")
    exact, run_exact = _port("float32")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL_QUANT", "1")
    quant, run = _port("float32")
    np.testing.assert_array_equal(quant.mesh.triangles, exact.mesh.triangles)
    cs = quant.grid.cell_size
    d = np.abs(quant.mesh.vertices - exact.mesh.vertices).max()
    assert 0 < d <= cs / 65535 * 1.01
    assert run["pull_bytes"] < run_exact["pull_bytes"]  # t in 2 bytes, not 4


def test_the_stitch_stays_the_default_and_gives_the_same_surface(monkeypatch):
    stitched, run = _port("float64")
    assert "stitch" in run["stage_s"] and "decode" not in run["stage_s"]
    monkeypatch.setenv(ENC, "1")
    enc, _ = _port("float64")
    assert (enc.mesh.num_vertices, enc.mesh.num_triangles) == (
        stitched.mesh.num_vertices, stitched.mesh.num_triangles)
    d, _ = cKDTree(stitched.mesh.vertices).query(enc.mesh.vertices)
    assert d.max() < 1e-9


@pytest.mark.parametrize("encoded", ["0", "1"])
def test_profile_sync_changes_the_clock_not_the_mesh(encoded, monkeypatch):
    monkeypatch.setenv(ENC, encoded)
    ts.enable_profile_sync(False)
    free, run_free = _port("float32")
    ts.enable_profile_sync(True)
    synced, run_synced = _port("float32")
    np.testing.assert_array_equal(free.mesh.triangles, synced.mesh.triangles)
    np.testing.assert_array_equal(free.mesh.vertices, synced.mesh.vertices)
    assert set(run_free["stage_s"]) == set(run_synced["stage_s"])
