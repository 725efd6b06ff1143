"""The port's route choice reads the reference's switches from the
environment at each call, with the reference's defaults: the dense gate
(``SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS``), the slab route's switch, slab
count and slab budget (``SPLASHSURF_TPU_SLAB_DENSE``,
``SPLASHSURF_TPU_SLAB_MAX_SLABS``, ``SPLASHSURF_TPU_SLAB_CELLS_BUDGET``) and
the grid bucketing (``SPLASHSURF_TPU_GRID_BUCKET``), and the subdomain
route's streaming gate (``SPLASHSURF_TPU_STREAM``,
``SPLASHSURF_TPU_STREAM_BUDGET_BYTES``). The readers are held
against the JAX package's own; the routes taken are held, end to end,
against the route its ``reconstruct_surface`` enters, and the meshes
against its meshes."""

import numpy as np
import pytest
import torch

import bench
import jax
import splashsurf_tpu as st
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import reconstruction as jr
from splashsurf_tpu import subdomains as jsub
from splashsurf_tpu.ops import slab_sweep as jslab
from splashsurf_tpu.params import GridDecompositionParameters as JGrid
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import reconstruction as tr
from splashsurf_tpu_torch import subdomains as tsub
from splashsurf_tpu_torch.ops import slab_sweep as tslab
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

SWITCHES = (
    "SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS",
    "SPLASHSURF_TPU_SLAB_DENSE",
    "SPLASHSURF_TPU_SLAB_MAX_SLABS",
    "SPLASHSURF_TPU_SLAB_CELLS_BUDGET",
    "SPLASHSURF_TPU_GRID_BUCKET",
)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_route(grid, n_sub=64):
    params = pt.Parameters.new_relative(
        0.011, 4.0, 1.5, grid_decomposition=pt.GridDecompositionParameters(n_sub)
    )
    return tr.choose_route(params, grid)


CUBE = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=0.0165, n_cells=(500, 500, 500))  # 125M
WIDE = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=0.0165, n_cells=(2000, 300, 300))  # 180M


@pytest.mark.parametrize(
    "env, grid, want",
    [
        ({}, CUBE, "dense"),
        ({}, WIDE, "slab"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "100000000"}, CUBE, "slab"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "100000000",
          "SPLASHSURF_TPU_SLAB_DENSE": "0"}, CUBE, "subdomain"),
        ({"SPLASHSURF_TPU_SLAB_DENSE": "0"}, WIDE, "subdomain"),
        ({"SPLASHSURF_TPU_SLAB_DENSE": "yes"}, WIDE, "subdomain"),  # only "1" turns slabs on
        ({"SPLASHSURF_TPU_SLAB_MAX_SLABS": "3"}, WIDE, "subdomain"),  # 4 slabs
        ({"SPLASHSURF_TPU_SLAB_MAX_SLABS": "4"}, WIDE, "slab"),
        ({"SPLASHSURF_TPU_SLAB_CELLS_BUDGET": "1000000"}, WIDE, "subdomain"),  # 182 slabs
        ({"SPLASHSURF_TPU_SLAB_CELLS_BUDGET": "1000000",
          "SPLASHSURF_TPU_SLAB_MAX_SLABS": "250"}, WIDE, "slab"),
    ],
)
def test_choose_route_follows_the_switches(monkeypatch, env, grid, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tr.global_dense_max_cells() == jr._global_dense_max_cells()
    assert tslab.gs_dense_gate() == jslab.gs_dense_gate()
    assert _port_route(grid) == want


def test_switches_are_read_at_each_call(monkeypatch):
    assert _port_route(CUBE) == "dense"
    monkeypatch.setenv("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", "1000")
    assert _port_route(CUBE) == "slab"
    monkeypatch.setenv("SPLASHSURF_TPU_SLAB_DENSE", "0")
    assert _port_route(CUBE) == "subdomain"


def test_the_dense_guard_is_not_a_switch(monkeypatch):
    # past 128M cells the dense route raises, whatever the gate says
    monkeypatch.setenv("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", "300000000")
    big = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=0.0165, n_cells=(600, 500, 500))
    with pytest.raises(ValueError, match="dense"):
        _port_route(big)


def _soup(mesh, cell_size):
    tri = np.round(np.asarray(mesh.vertices)[np.asarray(mesh.triangles)] / cell_size, 3)
    return sorted(tuple(sum(sorted(map(tuple, t)), ())) for t in tri)


@pytest.fixture(scope="module")
def dam():
    return bench.make_dam_break(2000, 0.011, seed=4)


def _reference(pts, params):
    jn.clear_density_plan()
    clear_grid_plan()
    return st.reconstruct_surface(pts, params)


def test_past_a_shrunk_gate_without_slabs_both_take_the_subdomain_route(dam, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", "1000")
    monkeypatch.setenv("SPLASHSURF_TPU_SLAB_DENSE", "0")
    jp = st.Parameters.new_relative(0.011, 4.0, 1.5, grid_decomposition=JGrid(16)).try_convert(
        "float64"
    )
    pts = dam.astype(np.float64)
    ref = _reference(pts, jp)
    rec = pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")
    assert ref.subdomain_grid is not None and rec.subdomain_grid is not None
    assert max(rec.grid.n_cells) > 1.2 * 16 and rec.grid.total_cells > 1000
    assert (rec.subdomain_grid.min, rec.subdomain_grid.n_cells) == (
        ref.subdomain_grid.min, ref.subdomain_grid.n_cells
    )
    assert rec.mesh.num_triangles == ref.mesh.num_triangles > 500
    assert _soup(rec.mesh, rec.grid.cell_size) == _soup(ref.mesh, rec.grid.cell_size)
    # with slabs on (the default), the port takes the slab route: the same
    # surface as the subdomain route's, as the reference's routing test holds
    monkeypatch.delenv("SPLASHSURF_TPU_SLAB_DENSE")
    tslab.LAST_RUN.clear()
    slab = pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")
    assert slab.subdomain_grid is None and tslab.LAST_RUN["slabbed"]
    assert (slab.mesh.num_vertices, slab.mesh.num_triangles) == (
        rec.mesh.num_vertices, rec.mesh.num_triangles
    )
    vs, vd = slab.mesh.vertices, rec.mesh.vertices
    np.testing.assert_allclose(vs[np.lexsort(vs.T)], vd[np.lexsort(vd.T)], rtol=0, atol=1e-9)


def test_grid_bucket_off_gives_the_reference_grid(dam, monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_GRID_BUCKET", "0")
    jp = st.Parameters.new_relative(0.011, 4.0, 1.5).try_convert("float64")
    pts = dam.astype(np.float64)
    raw = pt.grid_for_reconstruction(
        torch.as_tensor(pts), jp.particle_radius, jp.compact_support_radius, jp.cube_size
    )
    assert tr._bucket_grid(raw) is raw
    monkeypatch.delenv("SPLASHSURF_TPU_GRID_BUCKET")
    assert tr._bucket_grid(raw).n_cells != raw.n_cells  # bucketing would pad it
    monkeypatch.setenv("SPLASHSURF_TPU_GRID_BUCKET", "0")
    ref = _reference(pts, jp)
    rec = pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")
    assert rec.grid.n_cells == ref.grid.n_cells == raw.n_cells
    assert rec.grid.min == ref.grid.min
    np.testing.assert_array_equal(rec.mesh.triangles, np.asarray(ref.mesh.triangles))
    np.testing.assert_allclose(rec.mesh.vertices, np.asarray(ref.mesh.vertices), rtol=0, atol=1e-12)


class _Entered(Exception):
    """Raised by a spy in place of a route's reconstruction: (route, grid)."""


def _spy(monkeypatch, module, attr, route):
    def enter(positions, parameters, grid, **kw):
        raise _Entered(route, grid)

    monkeypatch.setattr(module, attr, enter)


def _route_entered(run):
    try:
        run()
    except _Entered as e:
        return e.args
    raise AssertionError("no route was entered")


@pytest.mark.parametrize(
    "env, want",
    [
        ({}, "dense"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000"}, "slab"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000", "SPLASHSURF_TPU_SLAB_DENSE": "0"},
         "subdomain"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000",
          "SPLASHSURF_TPU_SLAB_CELLS_BUDGET": "1000", "SPLASHSURF_TPU_SLAB_MAX_SLABS": "1"},
         "subdomain"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000",
          "SPLASHSURF_TPU_SLAB_CELLS_BUDGET": "1000"}, "slab"),
        ({"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": "1000", "SPLASHSURF_TPU_SLAB_DENSE": "0",
          "SPLASHSURF_TPU_GRID_BUCKET": "0"}, "subdomain"),
    ],
)
def test_both_packages_enter_the_same_route(dam, monkeypatch, env, want):
    """Each package's route entry points are replaced by spies: the route
    the JAX package's ``reconstruct_surface`` enters, and its grid, are the
    port's. The reference takes slabs on one device only; the port has one,
    so the reference is shown one (under the suite's 8 virtual devices it
    would never enter its slab route)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: devices(*a, **kw)[:1])
    _spy(monkeypatch, jgp, "reconstruct_surface_global", "dense")
    _spy(monkeypatch, jsub, "reconstruct_surface_subdomain_grid", "subdomain")
    _spy(monkeypatch, jslab, "reconstruct_surface_slabbed", "slab")
    _spy(monkeypatch, tgp, "reconstruct_surface_global", "dense")
    _spy(monkeypatch, tsub, "reconstruct_surface_subdomain_grid", "subdomain")
    _spy(monkeypatch, tslab, "reconstruct_surface_slabbed", "slab")
    jp = st.Parameters.new_relative(0.011, 4.0, 1.5, grid_decomposition=JGrid(16)).try_convert(
        "float64"
    )
    pts = dam.astype(np.float64)
    ref_route, ref_grid = _route_entered(lambda: _reference(pts, jp))
    assert ref_route == want
    route, grid = _route_entered(
        lambda: pt.reconstruct_surface(pts, pt.Parameters.from_reference(jp), device="cpu")
    )
    assert route == want
    assert grid.n_cells == tuple(ref_grid.n_cells)
    np.testing.assert_array_equal(grid.min, np.asarray(ref_grid.min))
    assert grid.cell_size == ref_grid.cell_size


def _gate_reached(name, block_on=None):
    """Stands in for the reference subdomain route's ``profile``: its first
    scope after the streaming gate ends the run there."""
    if name == "level set splat":
        raise _Entered("subdomain", None)
    return _profile(name, block_on=block_on)


_profile = jsub.profile


@pytest.mark.parametrize(
    "stream, below, want",
    [
        ("0", None, False),
        ("1", None, True),
        (None, None, False),  # auto, the 3 GB default budget
        (None, 0, False),  # auto, a budget equal to the level-set bytes
        ("auto", 1, True),  # auto, a budget one byte below them
        ("0", 1, False),
    ],
)
def test_streaming_gate_follows_the_reference(dam, monkeypatch, stream, below, want):
    """``SPLASHSURF_TPU_STREAM`` and ``SPLASHSURF_TPU_STREAM_BUDGET_BYTES``
    take the port's subdomain route down the reference's branch: its
    ``LAST_RUN["streamed"]`` and level-set bytes are the reference's (the
    reference run stops right after its gate)."""
    jp = st.Parameters.new_relative(
        0.011, 4.0, 1.5, grid_decomposition=JGrid(16, auto_disable=False)
    ).try_convert("float64")
    params = pt.Parameters.from_reference(jp)
    pts = dam.astype(np.float64)
    grid = tr._bucket_grid(pt.grid_for_reconstruction(
        torch.as_tensor(pts), jp.particle_radius, jp.compact_support_radius, jp.cube_size))
    sd = tsub.initialize_parameters(params, grid)
    B = len(tsub.occupied_segments(tsub.decompose(torch.as_tensor(pts), sd)[0])[0])
    ls_bytes = (B + 1) * sd.points_per_dim**3 * 8
    monkeypatch.delenv(tsub.STREAM_ENV, raising=False)
    monkeypatch.delenv(tsub.STREAM_BUDGET_ENV, raising=False)
    if stream is not None:
        monkeypatch.setenv(tsub.STREAM_ENV, stream)
    if below is not None:
        monkeypatch.setenv(tsub.STREAM_BUDGET_ENV, str(ls_bytes - below))

    monkeypatch.setattr(jsub, "profile", _gate_reached)
    jn.clear_density_plan()
    jgrid = st.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    _route_entered(lambda: jsub.reconstruct_surface_subdomain_grid(pts, jp, jgrid, sharded=False))
    rec = tsub.reconstruct_surface_subdomain_grid(torch.as_tensor(pts), params, grid)
    assert jsub.LAST_RUN["streamed"] == tsub.LAST_RUN["streamed"] == want
    assert jsub.LAST_RUN["ls_bytes"] == tsub.LAST_RUN["ls_bytes"] == ls_bytes
    assert jsub.LAST_RUN["B"] == B > 1
    assert rec.mesh.num_triangles > 500
