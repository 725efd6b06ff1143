"""Marching cubes of the PyTorch port against the JAX reference: the dense
``marching_cubes`` on the analytic sphere SDF (test_accuracy's oracle) and
the global cell-list ``mc_global_cells`` against its unencoded output."""

import numpy as np
import pytest
import torch

from splashsurf_tpu import mc as jmc
from splashsurf_tpu.mc import dense as jdense
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch.mc import dense as tdense
from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.uniform_grid import UniformGrid as TGrid

TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sphere_sdf_lists_equal_reference_and_within_1e4(dtype):
    # pysplashsurf test_sdf parity: 100^3 points over a 2.2-wide box
    radius, num = 1.0, 100
    dx = radius * 2.2 / (num - 1)
    translation = -0.5 * radius * 2.2
    coords = np.arange(num, dtype=dtype) * dx + translation
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    values = (radius - np.sqrt(X**2 + Y**2 + Z**2)).astype(dtype)

    ref = jmc.marching_cubes(values, 0.0, dx, (translation,) * 3)
    mesh = pt.marching_cubes(values, 0.0, dx, (translation,) * 3, device="cpu")
    assert mesh.vertices.dtype == dtype and mesh.triangles.dtype == np.int32
    counts = tdense._mc_counts(torch.as_tensor(values), 0.0)
    assert counts == tuple(int(c) for c in jdense._mc_counts(values, 0.0))
    assert counts == (mesh.num_vertices, mesh.num_triangles)
    np.testing.assert_array_equal(mesh.triangles, np.asarray(ref.triangles))
    # same formula; only rounding of the fused multiply-adds may differ
    np.testing.assert_allclose(
        mesh.vertices, np.asarray(ref.vertices), rtol=0,
        atol=1e-6 if dtype == np.float32 else 1e-14,
    )
    norms = np.linalg.norm(mesh.vertices, axis=1)
    assert norms.min() > radius - 1e-4 and norms.max() < radius + 1e-4
    assert pt.check_mesh_consistency(mesh.vertices, mesh.triangles) is None


def test_marching_cubes_needs_a_device_for_arrays(monkeypatch):
    """An array goes to CUDA unless ``device`` says otherwise: without CUDA
    that raises, it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.marching_cubes(np.zeros((3, 3, 3), np.float32), 0.5)
    assert pt.marching_cubes(np.zeros((3, 3, 3), np.float32), 0.5, device="cpu").num_vertices == 0
    mesh = pt.marching_cubes(torch.zeros((3, 3, 3)), 0.5)
    assert mesh.num_vertices == 0 and mesh.num_triangles == 0


def _blobs(shape, cs, dtype, seed):
    """A level set of a few Gaussian blobs, one of them cut by the far
    x/y/z boundary planes so boundary points own active edges (the surface
    is open there, so the mesh is not closed)."""
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    pos = np.stack([ii, jj, kk], -1) * cs
    ext = (np.asarray(shape) - 1) * cs
    centers = [rng.uniform(0.2, 0.8, 3) * ext for _ in range(3)] + [ext * 0.98]
    ls = np.zeros(shape)
    for c in centers:
        ls += np.exp(-np.sum((pos - c) ** 2, -1) / (0.15 * ext.min()) ** 2)
    return ls.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,seed", [((21, 17, 23), 0), ((16, 25, 12), 1)])
def test_mc_global_cells_equals_unencoded_reference(dtype, shape, seed):
    cs, mn, iso = 0.05, (-0.3, 0.1, 0.25), 0.6
    ls = _blobs(shape, cs, dtype, seed)
    n_cells = tuple(n - 1 for n in shape)
    jgrid = JGrid(min=mn, cell_size=cs, n_cells=n_cells)
    tgrid = TGrid(min=mn, cell_size=cs, n_cells=n_cells)
    n_pts = int(np.prod(shape))
    vx, vy, vz, t0, t1, t2, nv, nt = jgs.mc_global_cells(
        ls, jgrid, iso, 3 * n_pts, n_pts, encode=False
    )
    nv, nt = int(nv), int(nt)
    assert nt > 0
    ref_v = np.stack([np.asarray(a)[:nv] for a in (vx, vy, vz)], axis=1)
    ref_t = np.stack([np.asarray(a)[:nt] for a in (t0, t1, t2)], axis=1)

    verts, tris = tgs.mc_global_cells(torch.as_tensor(ls), tgrid, iso)
    assert tris.dtype == torch.int32 and verts.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_array_equal(tris.numpy(), ref_t)
    np.testing.assert_allclose(
        verts.numpy(), ref_v, rtol=0, atol=1e-6 if dtype == np.float32 else 1e-14
    )
