"""End-to-end ``reconstruct_surface`` with the cell-raster densities
(``SPLASHSURF_TPU_DENSITY_CELLRASTER``), PyTorch port against the JAX
reference's cell-raster warm frame on a small synthetic dam break.

The reference takes its cell-raster branch only on a warm frame (after a
planning frame of the same grid and particle count left no raster
overflow); a spy on its ``density_weights_from_rasters`` asserts that the
branch ran, and runs it with jit disabled (the same operations, one at a
time: its unrolled pair fan takes many seconds to compile on the CPU). The
port takes the branch on any frame without overflow and says so in
``neighbors.LAST_GATE``."""

import jax
import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.ops import global_sweep as tgs

RADIUS = 0.011
ENV = "SPLASHSURF_TPU_DENSITY_CELLRASTER"


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
    return bench.make_dam_break(3000, RADIUS, seed=1)


def _clear_jax_plans():
    jn.clear_density_plan()
    clear_grid_plan()
    jgs._OVER_PLAN.clear()
    jgs._MC_CAPS.clear()


def _jax_frames(frames, params, env):
    """The reference on each frame in turn under ``ENV=env``, plans cleared
    before and after; returns the results and how many frames ran its
    cell-raster densities."""
    calls = []
    orig = jgs.density_weights_from_rasters

    def spy(*a, **k):
        calls.append(1)
        with jax.disable_jit():
            return orig(*a, **k)

    _clear_jax_plans()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(ENV, env)
            mp.setattr(jgs, "density_weights_from_rasters", spy)
            recs = [st.reconstruct_surface(f, params) for f in frames]
    finally:
        _clear_jax_plans()
    return recs, len(calls)


@pytest.fixture(scope="module", params=["float64", "float32"])
def jax_cellraster(request, scene):
    """The reference's planning frame, then its cell-raster warm frame."""
    dtype = request.param
    jp = st.Parameters.new_relative(RADIUS, 4.0, 1.5).try_convert(dtype)
    pts = scene.astype(dtype)
    (plan, warm), n_cellraster = _jax_frames([pts, pts], jp, "1cpu")
    assert n_cellraster == 1  # the warm frame, not the planning frame
    return dtype, jp, pts, warm


def _port(pts, jp, env, monkeypatch):
    monkeypatch.setenv(ENV, env)
    return pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")


def test_matches_reference_cellraster_frame(jax_cellraster, monkeypatch):
    """f64: equal triangle lists, vertices within 1e-12, rho rtol 1e-12;
    f32: equal counts, vertices within 1e-4 (the reference ships t
    quantized to 16 bits), rho rtol 1e-5."""
    dtype, jp, pts, ref = jax_cellraster
    rec = _port(pts, jp, "1cpu", monkeypatch)
    assert tn.LAST_GATE["kind"] == "cellraster"
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    v, t = rec.mesh.vertices, rec.mesh.triangles
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == rv.shape[:1] + rt.shape[:1]
    assert rec.mesh.num_triangles > 1000
    rho, jrho = rec.particle_densities.numpy(), np.asarray(ref.particle_densities)
    if dtype == "float64":
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12)
        np.testing.assert_allclose(rho, jrho, rtol=1e-12, atol=0)
    else:
        assert np.abs(v - rv).max() < 1e-4
        np.testing.assert_allclose(rho, jrho, rtol=1e-5, atol=0)
    assert pt.check_mesh_consistency(v, t) is None


def test_matches_own_legacy_densities(jax_cellraster, monkeypatch):
    """The two density formulations of the port agree: rho rtol 1e-5 (the
    reference's own bar between them), equal counts, vertices within 1e-4."""
    _, jp, pts, _ = jax_cellraster
    cell = _port(pts, jp, "1cpu", monkeypatch)
    legacy = _port(pts, jp, "0", monkeypatch)
    assert tn.LAST_GATE["kind"] != "cellraster"
    np.testing.assert_allclose(
        cell.particle_densities.numpy(), legacy.particle_densities.numpy(), rtol=1e-5, atol=0
    )
    assert (cell.mesh.num_vertices, cell.mesh.num_triangles) == (
        legacy.mesh.num_vertices, legacy.mesh.num_triangles
    )
    assert np.abs(cell.mesh.vertices - legacy.mesh.vertices).max() < 1e-4


def test_clumped_scene_takes_the_legacy_densities(scene, monkeypatch):
    """The clump of test_reconstruct_global's overflow case (six particles
    within 0.2 r of one another) overflows the two raster slots: the port
    runs the legacy densities and matches the reference's legacy frame."""
    pts = scene.astype(np.float32)
    rng = np.random.default_rng(7)
    clump = pts[100][None, :] + rng.uniform(-0.2, 0.2, (6, 3)).astype(np.float32) * RADIUS
    fc = np.concatenate([pts[: len(pts) - 6], clump]).astype(np.float32)
    jp = st.Parameters.new_relative(RADIUS, 4.0, 1.5)
    tp = pt.Parameters.from_reference(jp)
    grid = pt.reconstruction._bucket_grid(
        pt.grid_for_reconstruction(torch.as_tensor(fc), RADIUS, tp.compact_support_radius, tp.cube_size)
    )
    hsc = pt.kernel_extents(tp.compact_support_radius, grid.cell_size).half_supported_cells
    assert tgs.rasterize_global(torch.as_tensor(fc), None, grid, 2, hsc, with_meta=True)[1] > 0
    rec = _port(fc, jp, "1cpu", monkeypatch)
    assert tn.LAST_GATE["kind"] not in ("cellraster", None)
    (ref,), _ = _jax_frames([fc], jp, "0")
    assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == (
        ref.mesh.num_vertices, ref.mesh.num_triangles
    )
    assert np.abs(rec.mesh.vertices - np.asarray(ref.mesh.vertices)).max() < 1e-4
    np.testing.assert_allclose(
        rec.particle_densities.numpy(), np.asarray(ref.particle_densities), rtol=2e-6, atol=0
    )
    assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None


@pytest.mark.parametrize("env", ["0", "1"])
def test_switch_off_never_takes_the_path(scene, env, monkeypatch):
    """"0" turns the path off everywhere; "1" turns it on for CUDA tensors
    only, so CPU tensors keep the legacy densities."""

    def refuse(*a, **k):
        raise AssertionError("cell-raster densities ran")

    monkeypatch.setattr(tgs, "density_weights_from_rasters", refuse)
    rec = _port(scene[:1500], st.Parameters.new_relative(RADIUS, 4.0, 1.5), env, monkeypatch)
    assert tn.LAST_GATE["kind"] != "cellraster" and rec.mesh.num_triangles > 0
