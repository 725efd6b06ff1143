"""The slab route of the PyTorch port (``ops.slab_sweep``).

- Against the port's dense route on the same grid, bit for bit: four
  slabs, 8-cell slabs with a ragged last one, and a clump that overflows
  the raster slots, in f32 and f64 (the reference's own scenes,
  ``tests/test_slab_sweep.py``).
- Against the JAX package's slab route on the same values: in f64 the same
  vertex and triangle lists, in f32 equal counts and vertices within 1e-4
  (the reference ships f32 edge parameters quantized to 16 bits).
- End to end: with default parameters and a shrunk dense gate, the port's
  ``reconstruct_surface`` takes the slab route (its run record says so) and
  gives its dense mesh bit for bit; in f64 the JAX package, shown one
  device (the only case in which it takes slabs), takes its slab route too
  and gives the same lists.
"""

import numpy as np
import pytest
import torch

import jax
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as jsub
from splashsurf_tpu.ops import slab_sweep as jslab
from splashsurf_tpu.reconstruction import clear_grid_plan
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.ops import slab_sweep as tslab
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.025


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, shape=(24, 10, 10), jitter=0.2):
    """A jittered lattice block at spacing 2r (the reference's slab scene)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    return (
        np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T * 2 * R
        + rng.uniform(-jitter, jitter, (nx * ny * nz, 3)) * 2 * R
    )


def _clump_scene():
    """The reference's overflow scene: 300 particles around one lattice
    particle push cells past the raster slots."""
    rng = np.random.default_rng(3)
    base = _scene(seed=2, shape=(20, 8, 8))
    return np.concatenate([base, base[555] + rng.uniform(-0.6, 0.6, (300, 3)) * R])


# name -> (positions, the slab count the cell budget aims at)
SCENES = {
    "four slabs": (_scene(), 4),
    "8-cell slabs": (_scene(seed=1), 64),
    "overflow clump": (_clump_scene(), 4),
}


def _inputs(pts, dtype):
    """The port's densities, weights m / rho, grid and kernel extent."""
    p = pt.Parameters.new_relative(R, 4.0, 1.5)
    x = torch.as_tensor(pts.astype(dtype))
    h = p.compact_support_radius
    grid = pt.grid_for_reconstruction(x, R, h, p.cube_size)
    hsc = pt.kernel_extents(h, grid.cell_size).half_supported_cells
    rho = tn.compute_particle_densities(x, h, p.particle_rest_mass)
    values = kernels.rounded(p.particle_rest_mass, x.dtype) / rho
    return x, values, grid, h, hsc, p.iso_surface_threshold


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(SCENES))
def test_slabs_equal_the_dense_route_bit_for_bit(name, dtype):
    pts, target = SCENES[name]
    x, values, grid, h, hsc, iso = _inputs(pts, dtype)
    v0, t0 = tgs.reconstruct_global_dense(x, values, grid, h, hsc, iso)
    v1, t1 = tslab.reconstruct_global_slabbed(
        x, values, grid, h, hsc, iso, max_cells=grid.total_cells // target + 1
    )
    run = tslab.LAST_RUN
    assert run["n_slabs"] >= 4 and len(run["rows"]) == run["n_slabs"]
    if target == 64:
        assert run["slab_w"] == 8 and grid.n_cells[0] % 8 != 0  # a ragged last slab
    if name == "overflow clump":
        assert tgs.rasterize_global(x, values, grid, 2, hsc)[1][0].shape[0] > 100
    assert t1.shape[0] > 1000
    assert torch.equal(t0, t1) and torch.equal(v0, v1)
    assert pt.check_mesh_consistency(v1.numpy(), t1.numpy()) is None


@pytest.mark.parametrize(
    "name, dtype",
    [("four slabs", "float64"), ("four slabs", "float32"), ("overflow clump", "float64")],
)
def test_slabs_match_the_reference_slab_route(name, dtype):
    pts, target = SCENES[name]
    x, values, grid, h, hsc, iso = _inputs(pts, dtype)
    maxc = grid.total_cells // target + 1
    v, t = tslab.reconstruct_global_slabbed(x, values, grid, h, hsc, iso, max_cells=maxc)
    jgrid = JGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    rv, rt = jslab.reconstruct_global_slabbed(
        x.numpy(), values.numpy(), jgrid, h, hsc, iso, slots=2, max_cells=maxc
    )
    assert jsub.LAST_RUN["n_slabs"] == tslab.LAST_RUN["n_slabs"]
    v, t = v.numpy(), t.numpy()
    assert v.shape == rv.shape and t.shape == rt.shape and t.shape[0] > 1000
    if dtype == "float64":
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12)
    else:
        assert np.abs(v - rv).max() < 1e-4


def _long_scene(dtype):
    """A 64 x 6 x 6 block: its 98-cell x extent is past 1.2 x 64, so default
    parameters (64-cell subdomains, auto-disable on) leave the dense route
    only by the gate."""
    return _scene(seed=5, shape=(64, 6, 6)).astype(dtype)


def _past_a_shrunk_gate(pts, params, monkeypatch):
    """The port's dense reconstruction, then the same call with the dense
    gate at 1000 cells and a slab budget of a fifth of the grid."""
    dense = pt.reconstruct_surface(pts, params, device="cpu")
    assert dense.grid.n_cells[0] > 1.2 * 64
    monkeypatch.setenv("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", "1000")
    monkeypatch.setenv("SPLASHSURF_TPU_SLAB_CELLS_BUDGET", str(dense.grid.total_cells // 5))
    tslab.LAST_RUN.clear()
    return dense, pt.reconstruct_surface(pts, params, device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_default_parameters_take_the_slab_route(dtype, monkeypatch):
    params = pt.Parameters.new_relative(R, 4.0, 1.5, dtype=dtype)
    dense, rec = _past_a_shrunk_gate(_long_scene(dtype), params, monkeypatch)
    assert tslab.LAST_RUN["slabbed"] and tslab.LAST_RUN["n_slabs"] == 6
    assert set(tslab.LAST_RUN["stage_s"]) == {
        "densities", "selection and raster", "sweep", "marching cubes", "merge and pull"
    }
    assert rec.subdomain_grid is None and rec.grid == dense.grid
    np.testing.assert_array_equal(rec.mesh.triangles, dense.mesh.triangles)
    np.testing.assert_array_equal(rec.mesh.vertices, dense.mesh.vertices)
    assert rec.mesh.vertices.dtype == np.dtype(dtype)
    assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None
    torch.testing.assert_close(rec.particle_densities, dense.particle_densities, rtol=0, atol=0)


def test_the_reference_takes_the_same_route_and_mesh(monkeypatch):
    """f64: the JAX package, shown one device, takes its slab route on the
    same grid and gives the same lists."""
    pts = _long_scene("float64")
    jp = st.Parameters.new_relative(R, 4.0, 1.5).try_convert("float64")
    _, rec = _past_a_shrunk_gate(pts, pt.Parameters.from_reference(jp), monkeypatch)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: devices(*a, **kw)[:1])
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "0")
    jn.clear_density_plan()
    clear_grid_plan()
    jsub.LAST_RUN.clear()
    ref = st.reconstruct_surface(pts, jp)
    assert jsub.LAST_RUN.get("slabbed") and jsub.LAST_RUN["n_slabs"] == tslab.LAST_RUN["n_slabs"]
    assert (tuple(ref.grid.n_cells), tuple(ref.grid.min)) == (rec.grid.n_cells, rec.grid.min)
    np.testing.assert_array_equal(rec.mesh.triangles, np.asarray(ref.mesh.triangles))
    np.testing.assert_allclose(rec.mesh.vertices, np.asarray(ref.mesh.vertices), rtol=0, atol=1e-12)


def test_slab_width():
    grid = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=0.1, n_cells=(40, 10, 12))
    assert tslab.slab_width_cells(grid, 10**9) == 40  # the budget covers the grid
    assert tslab.slab_width_cells(grid, 120 * 9) == 9
    assert tslab.slab_width_cells(grid, 100) == 8  # at least 8 cells
    jgrid = JGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    for budget in (10**9, 120 * 9, 100, 120 * 17 + 5):
        assert tslab.slab_width_cells(grid, budget) == jslab.slab_width_cells(jgrid, budget)
