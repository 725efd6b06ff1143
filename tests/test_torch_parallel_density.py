"""The port's sharded densities (``parallel.density``) on 8 (and 3)
virtual CPU shards, on the scenes of ``tests/test_parallel_density.py``:
against the port's single-device densities bit for bit, against the JAX
package's sharded densities on the grid cloud and the geoslot scene (its
one sharded program per scene), and against its single-device densities on
the raster formulation. The other cases are in
``test_torch_parallel_density_cases.py``."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import neighbors as jn
from splashsurf_tpu.parallel.density import (
    compute_particle_densities_sharded as jcompute_sharded,
)
from splashsurf_tpu.parallel.mesh import make_mesh as jmake_mesh

from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.parallel import mesh as pm
from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded

SUPPORT = 0.1
MASS = 0.37
RTOL = {np.float32: 2e-5, np.float64: 1e-10}


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
    monkeypatch.delenv(tn.GEOSLOT_ENV, raising=False)
    jn.clear_density_plan()
    yield
    pm.set_devices(None)


def _mesh(D=8):
    pm.set_devices(["cpu"] * D)
    return pm.make_mesh(device="cpu")


def _grid_cloud(side=14, jitter=0.3, seed=0, dtype=np.float32):
    """About one particle per bin."""
    rng = np.random.default_rng(seed)
    coords = (np.arange(side) + 0.5) * SUPPORT
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(dtype)
    return pts + (rng.uniform(-jitter, jitter, pts.shape) * SUPPORT).astype(dtype)


def _rest_lattice():
    """Rest spacing (half a bin) at an arbitrary phase: the geoslot scene."""
    rng = np.random.default_rng(1)
    spacing = SUPPORT / 2.0
    coords = (np.arange(16) + 0.5) * spacing
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    pts += (rng.uniform(-0.2, 0.2, pts.shape) * spacing).astype(np.float32)
    return pts + np.float32(0.2345)


def _overflow_scene():
    pts = _grid_cloud(side=12, seed=3)
    clump = np.tile(pts[100:101], (20, 1)) + (
        np.random.default_rng(7).uniform(-0.01, 0.01, (20, 3)).astype(np.float32) * SUPPORT
    )
    return np.concatenate([pts, clump]).astype(np.float32)


def _both(pts, mesh, **kw):
    """(sharded, single-device) port densities and the sharded record."""
    t = torch.as_tensor(pts)
    rho_s = compute_particle_densities_sharded(t, SUPPORT, MASS, mesh=mesh, **kw)
    gate = dict(tn.LAST_GATE["sharded"])
    nv = kw.get("n_valid", len(pts))
    rho_1 = tn.compute_particle_densities(t[:nv], SUPPORT, MASS)
    return rho_s.numpy(), rho_1.numpy(), gate


@pytest.fixture(scope="module")
def reference_sharded():
    """The JAX package's sharded densities on its 8 devices: the grid cloud
    and the geoslot scene."""
    mesh = jmake_mesh()
    assert mesh.devices.size == 8
    return {
        name: np.asarray(jcompute_sharded(pts, SUPPORT, MASS, mesh=mesh))
        for name, pts in (("grid", _grid_cloud()), ("geoslot", _rest_lattice()))
    }


@pytest.mark.parametrize("name", ["grid", "geoslot"])
def test_equal_to_single_device_and_near_the_reference_sharded(name, reference_sharded):
    pts = _grid_cloud() if name == "grid" else _rest_lattice()
    rho_s, rho_1, gate = _both(pts, _mesh())
    assert gate["kind"] == "geoslot"
    np.testing.assert_array_equal(rho_s, rho_1)
    np.testing.assert_allclose(rho_s, reference_sharded[name], rtol=RTOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("D", [8, 3])
def test_raster_formulation_bit_for_bit(monkeypatch, dtype, D):
    """With the geoslot switch off, the sorted raster formulation on the
    slabs, with slot ranks in the global (bin, index) order."""
    monkeypatch.setenv(tn.GEOSLOT_ENV, "0")
    pts = _grid_cloud(side=11, seed=2, dtype=dtype)
    rho_s, rho_1, gate = _both(pts, _mesh(D))
    assert gate["kind"] == "raster" and tn.LAST_GATE["single"]["kind"] == "raster"
    assert rho_s.dtype == dtype
    np.testing.assert_array_equal(rho_s, rho_1)
    ref = np.asarray(jn.compute_particle_densities(pts, SUPPORT, MASS))
    np.testing.assert_allclose(rho_s, ref, rtol=RTOL[dtype])
