"""Kernel K4's path on the CPU, PyTorch port against the JAX reference: the
pair-cell fan, the meta form of ``rasterize_global``, the plain pair sweep
against ``_pair_sweep_xla``, and ``density_weights_from_rasters``.

The reference's ``density_weights_from_rasters`` is jitted, and its
unrolled 275 x S pair fan takes many seconds to compile on the CPU; the
fixtures run it once per dtype with jit disabled (the same operations, one
at a time) and keep the pair sums its ``_pair_sweep_xla`` returned."""

import math

import jax
import numpy as np
import pytest
import torch

from splashsurf_tpu.aabb import Aabb3d as JAabb
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.ops.splat_pallas import pair_cell_offsets as j_pair_cell_offsets
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.ops import splat_kernels as sk
from splashsurf_tpu_torch.uniform_grid import UniformGrid as TGrid
from splashsurf_tpu_torch.uniform_grid import kernel_extents

SUPPORT = 0.1
MASS = 1.3e-3
# f32: the reference's own bar for kernel against scan
# (test_reconstruct_global); f64: rounding of ~100-term sums
TOL = {np.float32: dict(rtol=2e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=0)}
REL = {np.float32: dict(rtol=2e-5, atol=0), np.float64: dict(rtol=1e-12, atol=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(dtype, seed=0, n=700):
    """A cloud in a 16^3-cell grid (cube 0.0375, h/cs = 8/3) with a few
    particles outside it, which the rasterizer drops."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.05, 0.55, (n, 3))
    pts[:5] = rng.uniform(-0.5, -0.2, (5, 3))
    jgrid = JGrid.from_aabb(JAabb((0.0,) * 3, (0.6,) * 3), 0.0375)
    tgrid = TGrid(min=jgrid.min, cell_size=jgrid.cell_size, n_cells=jgrid.n_cells)
    hsc = kernel_extents(SUPPORT, jgrid.cell_size).half_supported_cells
    return pts.astype(dtype), jgrid, tgrid, hsc


def _args(jgrid, hsc):
    h_over_cs = SUPPORT / jgrid.cell_size
    return int(math.ceil(h_over_cs - 1e-9)), h_over_cs, hsc + 1


@pytest.fixture(scope="module", params=[np.float32, np.float64], ids=["f32", "f64"])
def reference(request):
    """The reference's meta raster, pair sums, fv and rho on one scene."""
    dtype = request.param
    pts, jgrid, tgrid, hsc = _scene(dtype)
    reach, h_over_cs, pad = _args(jgrid, hsc)
    r = jgs.rasterize_global(pts, pts[:, 0], jgrid, 2, hsc, 0, lane_align=1, with_meta=True)
    sums = []
    xla = jgs._pair_sweep_xla

    def keep(*a, **k):
        sums.append(np.asarray(xla(*a, **k)))
        return sums[-1]

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jgs, "_pair_sweep_xla", keep)
        fv, rho = jgs.density_weights_from_rasters(
            *r[:3], *r[8:], np.asarray(MASS, dtype), np.asarray(SUPPORT, dtype),
            jgrid, hsc, reach, h_over_cs, "xla",
        )
    return dict(
        dtype=dtype, pts=pts, tgrid=tgrid, hsc=hsc, raster=r, acc=sums[0],
        fv=np.asarray(fv), rho=np.asarray(rho),
    )


@pytest.mark.parametrize(
    "reach, h_over_cs", [(3, 8 / 3), (2, 2.0), (3, 2.5), (4, 3.7), (1, 0.9), (3, 2.2)]
)
def test_pair_cell_offsets_equal_reference(reach, h_over_cs):
    """Same offsets in the same (meshgrid) order; 275 of 343 at h/cs = 8/3."""
    got = sk.pair_cell_offsets(reach, h_over_cs)
    assert got == j_pair_cell_offsets(reach, h_over_cs)
    if (reach, h_over_cs) == (3, 8 / 3):
        assert len(got) == 275
    # one contiguous o2 run per (o0, o1), in the fan's order: the kernel's table
    runs = sk._runs(np.asarray(got, np.int32))
    flat = [(a, b, c) for a, b, lo, hi in runs for c in range(lo, hi)]
    assert flat == [tuple(map(int, o)) for o in got]


def test_rasterize_meta_equals_reference(reference):
    """Fractions, ranks, ``ok``, the overflow count and, for in-grid
    particles, the cells equal the reference's bit for bit."""
    r = reference["raster"]
    fracs, n_over, (rank, ok, *cell) = tgs.rasterize_global(
        torch.as_tensor(reference["pts"]), None, reference["tgrid"], 2, reference["hsc"],
        with_meta=True,
    )
    for got, want in zip(fracs, r[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n_over == int(r[7]) > 0
    np.testing.assert_array_equal(rank.numpy(), np.asarray(r[8]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r[9]))
    assert rank.dtype == cell[0].dtype == torch.int64
    inside = np.all(reference["pts"] >= 0.0, axis=1)  # all but the 5 outliers
    assert not ok.numpy()[~inside].any()
    for got, want in zip(cell, r[10:]):
        np.testing.assert_array_equal(got.numpy()[inside], np.asarray(want)[inside])


def _occupied(fx, pad, n_cells):
    inner = tuple(slice(pad, pad + n) for n in n_cells)
    return np.asarray(fx)[(slice(None),) + inner] < 1e14


def test_pair_sweep_plain_matches_reference(reference):
    """On occupied query slots (the reference's empty ones hold NaN in f32
    and a meaningless finite sum in f64)."""
    r, grid, dtype = reference["raster"], reference["tgrid"], reference["dtype"]
    reach, h_over_cs, pad = _args(grid, reference["hsc"])
    fr = [torch.as_tensor(np.array(a)) for a in r[:3]]
    got = sk.pair_sweep_plain(*fr, grid.cell_size, SUPPORT, reach, h_over_cs, pad, grid.n_cells)
    occ = _occupied(r[0], pad, grid.n_cells)
    assert got.shape == (2,) + grid.n_cells and got.dtype == fr[0].dtype
    assert occ.sum() > 600 and reference["acc"][occ].min() > 0
    np.testing.assert_allclose(got.numpy()[occ], reference["acc"][occ], **TOL[dtype])


def test_density_weights_match_reference(reference):
    """fv on occupied slots (exactly 0 elsewhere) and rho of every particle
    against the reference, from the port's own meta raster."""
    r, grid, dtype = reference["raster"], reference["tgrid"], reference["dtype"]
    reach, h_over_cs, pad = _args(grid, reference["hsc"])
    fracs, _, meta = tgs.rasterize_global(
        torch.as_tensor(reference["pts"]), None, grid, 2, reference["hsc"], with_meta=True
    )
    fv, rho = tgs.density_weights_from_rasters(
        *fracs, *meta, MASS, SUPPORT, grid, reference["hsc"], reach, h_over_cs
    )
    occ = np.zeros(fv.shape, bool)
    occ[(slice(None),) + tuple(slice(pad, pad + n) for n in grid.n_cells)] = _occupied(
        r[0], pad, grid.n_cells
    )
    assert fv.shape == fracs[0].shape and (fv.numpy()[~occ] == 0).all()
    np.testing.assert_allclose(fv.numpy()[occ], reference["fv"][occ], **REL[dtype])
    ok = meta[1].numpy()
    assert (rho.numpy()[~ok] == 0).all() and (rho.numpy()[ok] > 0).all()
    np.testing.assert_allclose(rho.numpy(), reference["rho"], **REL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pair_sweep_cuda_on_cpu_is_the_plain_version(dtype):
    """For CPU tensors the wrapper runs the plain version, launching
    nothing; a reach beyond the raster pad is refused."""
    pts, _, grid, hsc = _scene(dtype, seed=3, n=300)
    fracs, _, _ = tgs.rasterize_global(torch.as_tensor(pts), None, grid, 2, hsc, with_meta=True)
    reach, h_over_cs, pad = _args(grid, hsc)
    before = sk.pair_sweep_cuda.launches
    args = (grid.cell_size, SUPPORT, reach, h_over_cs, pad, grid.n_cells)
    got = sk.pair_sweep_cuda(*fracs, *args)
    want = sk.pair_sweep_plain(*fracs, *args)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(want, nan=-1.0))
    assert sk.pair_sweep_cuda.launches == before
    with pytest.raises(ValueError, match="reach"):
        sk.pair_sweep_cuda(*fracs, grid.cell_size, SUPPORT, pad + 1, h_over_cs, pad, grid.n_cells)
