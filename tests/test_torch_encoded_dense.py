"""The encoded mesh pull and edge-major marching cubes end to end on the
dense and slab routes: the port against the JAX package in the same mode
(the switches set through the environment, which both packages read per
call), on a small seeded dam break and the slab route's scenes.

- ``SPLASHSURF_TPU_PULL=encoded``: the JAX package's triangle list, and
  vertices within 1e-4 (f32) / 1e-9 (f64); with u16 t (``PULL_QUANT=1``,
  the default) the exact pull's triangles and vertices within cell_size /
  65535 * 1.01 of it (the reference's bar,
  ``tests/test_reconstruct_global.py:469-470``); the f32 decode native.
- The slab route encodes its slabs and merges their streams on the host:
  the dense route's encoded mesh bit for bit, and the JAX slab route's.
- ``SPLASHSURF_TPU_MC=edges``: the JAX package's edge-major mesh.
- With no switch set the port pulls the packed mesh, as before.
"""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.ops import slab_sweep as jslab
from splashsurf_tpu.reconstruction import clear_grid_plan
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import kernels, native
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.ops import slab_sweep as tslab
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

RADIUS = 0.011
SWITCHES = ("SPLASHSURF_TPU_PULL", "SPLASHSURF_TPU_PULL_QUANT", "SPLASHSURF_TPU_MC")


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
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "0")


@pytest.fixture(scope="module")
def scene():
    return bench.make_dam_break(3000, RADIUS, seed=1)


def _reference(pts, params):
    jn.clear_density_plan()
    clear_grid_plan()
    return st.reconstruct_surface(pts, params)


def _port(pts, params):
    from torch_gate import clear_port_plans

    clear_port_plans()
    return pt.reconstruct_surface(pts, params, device="cpu")


def _params(dtype):
    jp = st.Parameters.new_relative(RADIUS, 4.0, 1.5).try_convert(dtype)
    return jp, pt.Parameters.from_reference(jp)


def _same(rec, ref, dtype):
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    v, t = rec.mesh.vertices, rec.mesh.triangles
    assert v.dtype == np.dtype(dtype) and t.dtype == np.int32
    assert t.shape == rt.shape and t.shape[0] > 1000
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9 if dtype == "float64" else 1e-4)
    assert pt.check_mesh_consistency(v, t) is None


@pytest.mark.parametrize("dtype, quant", [("float32", "1"), ("float32", "0"), ("float64", "1")])
def test_dense_encoded_pull_matches_the_reference(scene, dtype, quant, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL_QUANT", quant)
    jp, tp = _params(dtype)
    ref = _reference(scene.astype(dtype), jp)
    before = dict(native.DECODE_STATS)
    rec = _port(scene.astype(dtype), tp)
    assert tgs.LAST_PULL["mode"] == "encoded" and rec.subdomain_grid is None
    engine = "native" if dtype == "float32" else "numpy"
    assert native.DECODE_STATS[engine] == before[engine] + 1
    _same(rec, ref, dtype)


def test_quantized_pull_keeps_the_exact_triangles(scene, monkeypatch):
    """Within the port: u16 t against f32 t against the packed mesh."""
    _, tp = _params("float32")
    pts = scene.astype(np.float32)
    meshes = {}
    for mode, quant in (("packed", "1"), ("encoded", "0"), ("encoded", "1")):
        monkeypatch.setenv("SPLASHSURF_TPU_PULL", mode)
        monkeypatch.setenv("SPLASHSURF_TPU_PULL_QUANT", quant)
        meshes[mode, quant] = _port(pts, tp).mesh
        assert tgs.LAST_PULL["bytes"] > 0
    packed, exact, quant = meshes["packed", "1"], meshes["encoded", "0"], meshes["encoded", "1"]
    for m in (exact, quant):
        np.testing.assert_array_equal(m.triangles, packed.triangles)
    assert np.abs(exact.vertices - packed.vertices).max() <= 1e-6
    cs = float(tp.cube_size)
    assert 0 < np.abs(quant.vertices - exact.vertices).max() <= cs / 65535 * 1.01


def test_encoded_pull_copies_fewer_bytes(scene, monkeypatch):
    _, tp = _params("float32")
    pts = scene.astype(np.float32)
    got = {}
    for mode in ("packed", "encoded"):
        monkeypatch.setenv("SPLASHSURF_TPU_PULL", mode)
        rec = _port(pts, tp)
        got[mode] = tgs.LAST_PULL["bytes"]
    m = rec.mesh
    assert got["packed"] == 12 * (m.num_vertices + m.num_triangles)
    assert got["encoded"] < got["packed"] / 2


def _slab_inputs(dtype, seed=0, shape=(24, 10, 10)):
    """The slab route's scene (a jittered lattice block at spacing 2r, the
    reference's ``tests/test_slab_sweep.py``) and the port's inputs."""
    r = 0.025
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    pts = (np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T * 2 * r
           + rng.uniform(-0.2, 0.2, (nx * ny * nz, 3)) * 2 * r)
    p = pt.Parameters.new_relative(r, 4.0, 1.5)
    x = torch.as_tensor(pts.astype(dtype))
    h = p.compact_support_radius
    grid = pt.grid_for_reconstruction(x, r, h, p.cube_size)
    hsc = pt.kernel_extents(h, grid.cell_size).half_supported_cells
    rho = tn.compute_particle_densities(x, h, p.particle_rest_mass)
    values = kernels.rounded(p.particle_rest_mass, x.dtype) / rho
    return x, values, grid, h, hsc, p.iso_surface_threshold


@pytest.mark.parametrize("quant", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_encoded_slabs_equal_the_dense_route_bit_for_bit(dtype, quant, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL_QUANT", quant)
    x, values, grid, h, hsc, iso = _slab_inputs(dtype)
    v0, t0 = tgs.reconstruct_global_dense(x, values, grid, h, hsc, iso)
    assert tgs.LAST_PULL["mode"] == "encoded"
    v1, t1 = tslab.reconstruct_global_slabbed(
        x, values, grid, h, hsc, iso, max_cells=grid.total_cells // 4 + 1
    )
    run = tslab.LAST_RUN
    assert run["n_slabs"] >= 4 and run["pull_bytes"] > 0 and "decode" in run["stage_s"]
    assert t1.shape[0] > 1000
    assert torch.equal(t0, t1) and torch.equal(v0, v1)
    assert pt.check_mesh_consistency(v1.numpy(), t1.numpy()) is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_encoded_slabs_match_the_reference_slab_route(dtype, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")
    x, values, grid, h, hsc, iso = _slab_inputs(dtype, seed=1)
    maxc = grid.total_cells // 64 + 1  # 8-cell slabs, a ragged last one
    v, t = tslab.reconstruct_global_slabbed(x, values, grid, h, hsc, iso, max_cells=maxc)
    assert tslab.LAST_RUN["slab_w"] == 8
    jgrid = JGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    rv, rt = jslab.reconstruct_global_slabbed(
        x.numpy(), values.numpy(), jgrid, h, hsc, iso, slots=2, max_cells=maxc
    )
    np.testing.assert_array_equal(t.numpy(), rt)
    np.testing.assert_allclose(v.numpy(), rv, rtol=0, atol=1e-9 if dtype == "float64" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_major_mc_matches_the_reference(scene, dtype, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_MC", "edges")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")  # MC=edges forces the packed pull
    jp, tp = _params(dtype)
    ref = _reference(scene.astype(dtype), jp)
    rec = _port(scene.astype(dtype), tp)
    assert tgs.LAST_PULL["mode"] == "edges"
    _same(rec, ref, dtype)
    # the cell-major mesh: the same lists
    monkeypatch.delenv("SPLASHSURF_TPU_MC")
    monkeypatch.delenv("SPLASHSURF_TPU_PULL")
    cells = _port(scene.astype(dtype), tp).mesh
    np.testing.assert_array_equal(rec.mesh.triangles, cells.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, cells.vertices)


def test_no_switch_keeps_the_packed_pull(scene, monkeypatch):
    _, tp = _params("float32")
    pts = scene.astype(np.float32)
    default = _port(pts, tp).mesh
    assert tgs.LAST_PULL["mode"] == "packed"
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "packed")
    packed = _port(pts, tp).mesh
    np.testing.assert_array_equal(default.triangles, packed.triangles)
    np.testing.assert_array_equal(default.vertices, packed.vertices)
