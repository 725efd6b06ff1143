"""The pieces of the subdomain route of the PyTorch port against the JAX
reference, on a small canyon sheet: the decomposition (both ghost
expansions), the chunk raster splat (plain K3 plus the overflow scatter)
against the reference's scan formulation, the scatter splat, the halo
overwrite (bit for bit), and K3's plain version against the reference's
scan sweep on random rasters."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu as st
from splashsurf_tpu import subdomains as js
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.params import GridDecompositionParameters as JGrid
from splashsurf_tpu.reconstruction import grid_for_reconstruction

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.ops import splat_kernels as sk

RADIUS = 0.05
# f32: the reference's own kernel-vs-scan bar; f64: rounding
TOL = {
    np.float32: dict(rtol=1e-5, atol=2e-5),
    np.float64: dict(rtol=1e-10, atol=1e-12),
}
# (n_sub, cube size relative to the radius): hsc = 3 with n_sub > 2 hsc
# takes the 8-way ghost expansion, hsc = 4 with n_sub <= 2 hsc the 27-way
MODES = {"8-way": (16, 1.5), "27-way": (8, 1.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def canyon():
    return bench.make_canyon(3000, RADIUS, seed=2)


def _setup(pts, n_sub, rel_cube, dtype):
    """The same decomposition parameters in both packages."""
    jp = st.Parameters.new_relative(
        RADIUS, 4.0, rel_cube, grid_decomposition=JGrid(n_sub, auto_disable=False)
    ).try_convert(np.dtype(dtype).name)
    grid = grid_for_reconstruction(pts, jp.particle_radius, jp.compact_support_radius, jp.cube_size)
    sd_j = js.initialize_parameters(jp, grid)
    tgrid = pt.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    sd_t = ts.initialize_parameters(pt.Parameters.from_reference(jp), tgrid)
    assert sd_t.global_grid.n_cells == sd_j.global_grid.n_cells
    assert sd_t.num_subdomains == sd_j.num_subdomains
    assert sd_t.margin_cells == sd_j.margin_cells
    return jp, sd_j, sd_t


def _jax_pairs(pts, sd_j):
    tgt, pid, cell, rank, n_pairs = js.decompose(pts, sd_j, 2 * 27 * len(pts))
    k = int(n_pairs)
    return [np.asarray(a[:k]).astype(np.int64) for a in (tgt, pid, cell, rank)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", list(MODES))
def test_decompose_matches_reference(canyon, mode, dtype):
    pts = canyon.astype(dtype)
    n_sub, rel_cube = MODES[mode]
    _, sd_j, sd_t = _setup(pts, n_sub, rel_cube, dtype)
    assert (n_sub > 2 * sd_t.margin_cells) == (mode == "8-way")
    want = _jax_pairs(pts, sd_j)
    got = [a.numpy() for a in ts.decompose(torch.as_tensor(pts), sd_t)]
    assert got[0].shape[0] > len(pts)  # ghosts
    for name, g, w in zip(("targets", "particle ids", "raster cells", "ranks"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    ids, starts, counts = ts.occupied_segments(torch.as_tensor(got[0]))
    jids, jstarts, jcounts = js._segments(want[0])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(counts, jcounts)


def _chunk_inputs(pts, sd_j, dtype, seed=0):
    """One chunk of every occupied subdomain: the reference's padded (C, K)
    tables and the port's flat pair lists of the same pairs."""
    tgt, pid, cell, rank = _jax_pairs(pts, sd_j)
    ids, starts, counts = js._segments(tgt)
    values = np.random.default_rng(seed).uniform(0.5, 1.5, len(pts)).astype(dtype) * 1e-3
    ns = sd_j.num_subdomains
    sub_ijk = np.stack([ids // (ns[1] * ns[2]), (ids // ns[2]) % ns[1], ids % ns[2]], 1)
    K = int(counts.max())
    slot = np.arange(K)[None, :]
    mask = slot < counts[:, None]
    take = lambda a, fill: np.where(mask, a[np.minimum(starts[:, None] + slot, len(a) - 1)], fill)
    n = len(pts)
    jax_args = dict(
        positions_ext=np.concatenate([pts, np.full((1, 3), 1e15 if dtype == np.float64 else 1e30, dtype)]),
        values_ext=np.concatenate([values, np.zeros(1, dtype)]),
        plists=take(pid, n).astype(np.int32),
        plocal=take(cell, 0).astype(np.int32),
        prank=take(rank, 1 << 30).astype(np.int32),
        sub_ijk=sub_ijk.astype(np.int32),
    )
    row = np.repeat(np.arange(len(ids)), counts)
    port_args = dict(
        positions=torch.as_tensor(pts), values=torch.as_tensor(values),
        pids=torch.as_tensor(pid), rows=torch.as_tensor(row),
        cells=torch.as_tensor(cell), ranks=torch.as_tensor(rank),
        sub_ijk=torch.as_tensor(sub_ijk),
    )
    return jax_args, port_args


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_raster_splat_matches_reference(canyon, dtype):
    # cubes of 2.5 radii hold up to about two particles each: many rank >= 2
    # pairs, yet at most the reference's 256 per subdomain (past that its
    # caller redoes the chunk by scatter)
    pts = canyon.astype(dtype)
    jp, sd_j, sd_t = _setup(pts, 8, 2.5, dtype)
    ja, ta = _chunk_inputs(pts, sd_j, dtype)
    assert int((ta["ranks"] >= 2).sum()) > 100  # the overflow scatter runs
    hsc = sd_t.margin_cells
    want, over = js.chunk_levelset_raster(
        ja["positions_ext"], ja["values_ext"], ja["plists"], ja["plocal"], ja["prank"],
        ja["sub_ijk"], sd_j, jp.compact_support_radius, hsc, unroll=False,
    )
    got = ts.chunk_levelset_raster(
        ta["positions"], ta["values"], ta["pids"], ta["rows"], ta["cells"], ta["ranks"],
        ta["sub_ijk"], sd_t, jp.compact_support_radius, hsc,
    )
    assert 0 < int(over) <= 256
    assert got.shape == want.shape and float(got.max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_scatter_splat_matches_reference(canyon, dtype):
    pts = canyon[:1200].astype(dtype)
    jp, sd_j, sd_t = _setup(pts, 8, 1.5, dtype)
    ja, ta = _chunk_inputs(pts, sd_j, dtype, seed=1)
    hsc = sd_t.margin_cells
    want = js.chunk_levelset_scatter(
        ja["positions_ext"], ja["values_ext"], ja["plists"], ja["sub_ijk"], sd_j,
        jp.compact_support_radius, hsc,
    )
    got = ts.chunk_levelset_scatter(
        ta["positions"], ta["values"], ta["pids"], ta["rows"], ta["sub_ijk"], sd_t,
        jp.compact_support_radius, hsc,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_halo_overwrite_is_bit_equal(canyon, dtype):
    _, sd_j, sd_t = _setup(canyon, 8, 1.5, dtype)
    ids, _, _ = js._segments(_jax_pairs(canyon, sd_j)[0])
    ns = sd_t.num_subdomains
    sub_ijk = np.stack([ids // (ns[1] * ns[2]), (ids // ns[2]) % ns[1], ids % ns[2]], 1)
    jidx, jflat = js._neighbor_tables(ids, sub_ijk.astype(np.int32), sd_j)
    tidx, tflat = ts._neighbor_tables(ids, sub_ijk, sd_t)
    np.testing.assert_array_equal(tidx, jidx)
    present = jflat != np.iinfo(np.int32).max
    np.testing.assert_array_equal(tflat[present], jflat[present])
    assert (tflat[~present] == ts._ABSENT).all() and present.sum() > 50
    P = sd_t.points_per_dim
    ls = np.random.default_rng(3).uniform(0, 1, (len(ids), P, P, P)).astype(dtype)
    want = np.asarray(js.halo_overwrite(ls, ids.astype(np.int32), jidx, jflat))
    for chunk in (None, 3):
        got = ts.halo_overwrite(
            torch.as_tensor(ls.copy()), torch.as_tensor(ids), torch.as_tensor(tidx),
            torch.as_tensor(tflat), chunk=chunk,
        )
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, ls)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("hsc,margin", [(2, 2), (3, 3), (2, 3)])
def test_splat_sweep_plain_matches_scan(dtype, hsc, margin):
    """K3's plain version on random padded rasters with empty slots, against
    the reference's scan sweep run on each subdomain's rasters (the same
    sum with pad = margin + 1)."""
    rng = np.random.default_rng(hsc + 7 * margin)
    C, S, P, cs = 3, 2, 7, 0.05
    Rp = P + 2 * margin + 1
    shape = (C, S, Rp, Rp, Rp)
    fr = rng.uniform(0, cs, (3,) + shape).astype(dtype)
    v = rng.uniform(0.5, 1.0, shape).astype(dtype)
    empty = rng.uniform(size=shape) < 0.6
    far = np.inf if dtype == np.float32 else 1e15
    fr[:, empty] = far
    v[empty] = 0.0
    h = cs * hsc * 0.9
    rasters = [torch.as_tensor(a) for a in (*fr, v)]
    got = sk.splat_sweep_plain(*rasters, cs, h, hsc, margin, P)
    assert got.shape == (C, P, P, P)
    # the wrapper takes the plain version on CPU tensors, uncounted
    before = sk.splat_sweep_cuda.launches
    np.testing.assert_array_equal(sk.splat_sweep_cuda(*rasters, cs, h, hsc, margin, P).numpy(), got.numpy())
    assert sk.splat_sweep_cuda.launches == before
    # the reference's scan with pad = hsc + 1 reads the window at margin - hsc
    lo = margin - hsc
    win = (slice(lo, Rp - lo),) * 3
    grid = st.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=cs, n_cells=(P - 1,) * 3)
    none = np.zeros(0, dtype)
    for c in range(C):
        want = jgs.sweep_global(
            *[a[c][(slice(None),) + win] for a in (*fr, v)], none, none, none, none,
            grid, h, hsc, backend="scan",
        )
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want), **TOL[dtype])


def test_splat_sweep_rejects_bad_inputs():
    r = [torch.zeros((2, 2, 12, 12, 12)) for _ in range(4)]
    with pytest.raises(ValueError):
        sk.splat_sweep_cuda(*r[:3], r[3][:, :1], 0.05, 0.1, 2, 2, 7)
    with pytest.raises(ValueError):
        sk.splat_sweep_cuda(*[x[0] for x in r], 0.05, 0.1, 2, 2, 7)
    meta = [torch.empty((2, 2, 12, 12, 12), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        sk.splat_sweep_cuda(*meta, 0.05, 0.1, 2, 2, 7)
