"""The route choice with several devices, and the sharded demo.

With more than one device the reference never takes the slab route: a
grid past the dense gate goes to the subdomain route, which shards from
``SPLASHSURF_TPU_SHARD_MIN_N`` particles on (read at each call). Each
package's route entry points and density wrappers are replaced by spies,
as ``tests/test_torch_route_env.py`` does: the route each enters, with 8
devices (the JAX suite's virtual devices, 8 virtual CPU shards in the port)
and with 1, is the same. ``sharded_reconstruction_demo(8)`` gives the JAX
demo's counts once the JAX demo keeps all its pairs."""

import jax
import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import subdomains as jsub
from splashsurf_tpu.ops import slab_sweep as jslab
from splashsurf_tpu.parallel import density as jpd
from splashsurf_tpu.parallel.mesh import sharded_reconstruction_demo as jdemo
from splashsurf_tpu.params import GridDecompositionParameters as JGrid
from splashsurf_tpu.reconstruction import clear_grid_plan

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import subdomains as tsub
from splashsurf_tpu_torch.ops import slab_sweep as tslab
from splashsurf_tpu_torch.parallel import density as tpd
from splashsurf_tpu_torch.parallel import mesh as pm
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

SWITCHES = (
    "SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS",
    "SPLASHSURF_TPU_SLAB_DENSE",
    "SPLASHSURF_TPU_SLAB_MAX_SLABS",
    "SPLASHSURF_TPU_SLAB_CELLS_BUDGET",
    "SPLASHSURF_TPU_GRID_BUCKET",
    "SPLASHSURF_TPU_SHARD_MIN_N",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    yield
    pm.set_devices(None)


class _Entered(Exception):
    """Raised by a spy in place of a route or a density stage."""


def _spy(monkeypatch, module, attr, what):
    def enter(*args, **kw):
        raise _Entered(what)

    monkeypatch.setattr(module, attr, enter)


def _entered(run):
    try:
        run()
    except _Entered as e:
        return e.args[0]
    raise AssertionError("no spy was entered")


@pytest.fixture(scope="module")
def dam():
    return bench.make_dam_break(2000, 0.011, seed=4).astype(np.float64)


@pytest.mark.parametrize(
    "n_dev, shard_min, want",
    [
        (8, "1000", "subdomain, sharded"),
        (8, None, "subdomain, one device"),  # 2000 particles < the default 262144
        (1, "1000", "slab"),
    ],
)
def test_both_packages_enter_the_same_route(dam, monkeypatch, n_dev, shard_min, want):
    monkeypatch.setenv("SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS", "1000")
    if shard_min is not None:
        monkeypatch.setenv("SPLASHSURF_TPU_SHARD_MIN_N", shard_min)
    devices = jax.devices
    assert len(devices()) == 8
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: devices(*a, **kw)[:n_dev])
    pm.set_devices(["cpu"] * n_dev if n_dev > 1 else None)

    _spy(monkeypatch, jgp, "reconstruct_surface_global", "dense")
    _spy(monkeypatch, jslab, "reconstruct_surface_slabbed", "slab")
    _spy(monkeypatch, jn, "compute_particle_densities", "subdomain, one device")
    _spy(monkeypatch, jpd, "compute_particle_densities_sharded", "subdomain, sharded")
    _spy(monkeypatch, tgp, "reconstruct_surface_global", "dense")
    _spy(monkeypatch, tslab, "reconstruct_surface_slabbed", "slab")
    _spy(monkeypatch, tsub, "compute_particle_densities", "subdomain, one device")
    _spy(monkeypatch, tpd, "compute_particle_densities_sharded", "subdomain, sharded")
    jp = st.Parameters.new_relative(0.011, 4.0, 1.5, grid_decomposition=JGrid(16)).try_convert(
        "float64")

    def reference():
        jn.clear_density_plan()
        clear_grid_plan()
        st.reconstruct_surface(dam, jp)

    assert _entered(reference) == want
    assert _entered(lambda: pt.reconstruct_surface(
        dam, pt.Parameters.from_reference(jp), device="cpu")) == want


def test_shard_min_n_is_read_at_each_call(monkeypatch):
    pm.set_devices(["cpu"] * 4)
    cpu = pm.make_mesh(device="cpu").devices[0]
    assert tsub.shard_mesh(None, 262144, cpu).size == 4
    assert tsub.shard_mesh(None, 262143, cpu) is None
    monkeypatch.setenv("SPLASHSURF_TPU_SHARD_MIN_N", "10")
    assert tsub.shard_mesh(None, 10, cpu).size == 4
    assert tsub.shard_mesh(False, 10, cpu) is None
    assert tsub.shard_mesh(True, 1, cpu).size == 4
    pm.set_devices(None)
    assert tsub.shard_mesh(True, 10**9, cpu) is None


def test_demo_matches_the_reference_demo(monkeypatch):
    """The reference's demo sizes its pair list at 2 N (``_pow2_at_least(2 *
    len(pts))`` = 4,096 slots), but its cloud expands into more pairs: the
    excess is dropped and fewer subdomains come out. The port sizes its
    pairs exactly; with the reference's list made large enough, the two
    demos give the same counts."""
    pm.set_devices(["cpu"] * 8)
    got = pm.sharded_reconstruction_demo(8, device="cpu")
    assert got["devices"] == 8 and got["triangles"] > 0
    truncated = jdemo(8)
    assert truncated["devices"] == 8 and truncated["subdomains"] < got["subdomains"]
    pow2 = jsub._pow2_at_least
    n_pts = 12**3  # the demo's lattice cloud
    monkeypatch.setattr(
        jsub, "_pow2_at_least", lambda n, lo=64: pow2(8 * n if n == 2 * n_pts else n, lo))
    assert jdemo(8) == got
