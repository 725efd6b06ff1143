"""Kernel K5, the binned formulation's density sweep
(``ops.splat_kernels.binned_sweep_cuda``), and its plain version.

On the CPU the wrapper runs the plain version: through
``neighbors.compute_particle_densities_binned`` it is held to a float64
all-pairs density on small two-box clouds whose fullest bin holds exactly K
particles, for K = 8, 16, 24, both lookups of the neighbour bins (the dense
rank table, and the binary search that lattices past ``RANK_TABLE_MAX``
take), with the rows cut to the occupied bins and with all ``u_cap`` rows,
and for binned8 (K = 8 with the overflow correction). On a card
(``-m card``; this file imports no JAX, so ``python -m pytest --noconftest
-m card tests/test_torch_binned_sweep.py`` runs it there) the kernel is held
to the plain version."""

import functools
import math

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch.ops import splat_kernels as sk

H = 0.044  # the compact support and the bin size
MASS = 1.0
# the plain version against the float64 all-pairs sum: f32 positions give
# differences and squared distances rounded to 2^-24 relative, and sums of
# up to a few hundred terms; f64 rounds at 2^-53
TOL = {
    torch.float32: dict(rtol=2e-5, atol=1e-5),
    torch.float64: dict(rtol=1e-10, atol=0),
}
# two-box clouds (side, seed) whose fullest bin holds exactly K particles
CLOUDS = {8: (0.4, 1), 16: (0.24, 3), 24: (0.19, 0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _cloud(K: int) -> np.ndarray:
    """2400 particles in two boxes 0.3 apart: a lattice with empty bins
    between and around the fluid."""
    side, seed = CLOUDS[K]
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, side, (1200, 3))
    b = rng.uniform(0, side, (1200, 3)) + np.array([side + 0.3, 0.1, 0.05])
    return np.concatenate([a, b])


@functools.cache
def _brute_force(K: int, dtype) -> np.ndarray:
    """m * sum_j W(|x_i - x_j|) over all pairs in float64, from the
    positions as ``dtype`` holds them."""
    pts = torch.as_tensor(_cloud(K)).to(dtype).double().numpy()
    r = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    q = 2.0 * r / H
    f = np.clip(2.0 - q, 0, None) ** 3 - 4.0 * np.clip(1.0 - q, 0, None) ** 3
    return MASS * 8.0 / H**3 / (4.0 * math.pi) * f.sum(1)


def _cell_list(K: int, dtype):
    pts = torch.as_tensor(_cloud(K)).to(dtype)
    grid = tn.BinGrid.for_domain(pts.min(0).values.double().numpy(),
                                 pts.max(0).values.double().numpy(), H)
    cl = tn.build_cell_list(pts, grid)
    max_occ, n_bins, over8 = tn.bin_stats_ex(cl)
    return pts, grid, cl, max_occ, n_bins, over8


@pytest.mark.parametrize("occupied", [True, False], ids=["occupied-rows", "u_cap-rows"])
@pytest.mark.parametrize("lookup", ["rank-table", "binary-search"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("K", [8, 16, 24])
def test_plain_matches_all_pairs(monkeypatch, K, dtype, lookup, occupied):
    if lookup == "binary-search":
        monkeypatch.setattr(tn, "RANK_TABLE_MAX", 0)
    pts, grid, cl, max_occ, n_bins, _ = _cell_list(K, dtype)
    assert max_occ == K  # the cloud's premise: some bin is full
    u_cap = tn.binned_plan(len(pts), grid.lattice, n_bins, max_occ, 0)["u_cap"]
    assert u_cap > n_bins  # the u_cap case sweeps rows past the occupied bins
    tables = tn.binned_sweep_inputs(grid, cl, u_cap)
    assert (tables[3] is None) == (lookup == "binary-search")
    rho = tn.compute_particle_densities_binned(
        pts, grid, cl, H, MASS, K, u_cap, occupied=n_bins if occupied else None
    )
    assert rho.dtype == dtype
    np.testing.assert_allclose(rho.double().numpy(), _brute_force(K, dtype), **TOL[dtype])


@pytest.mark.parametrize("lookup", ["rank-table", "binary-search"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_binned8_with_overflow_correction_matches_all_pairs(monkeypatch, dtype, lookup):
    if lookup == "binary-search":
        monkeypatch.setattr(tn, "RANK_TABLE_MAX", 0)
    pts, grid, cl, max_occ, n_bins, over8 = _cell_list(16, dtype)
    assert max_occ > 8 and over8 > 0  # the sweep leaves rank >= 8 out
    u_cap = tn.binned_plan(len(pts), grid.lattice, n_bins, max_occ, over8)["u_cap"]
    rho = tn.compute_particle_densities_binned(
        pts, grid, cl, H, MASS, 8, u_cap, overflow_capacity=tn.overflow_lists_capacity(over8),
        candidate_capacity=tn._round_up(max_occ + 8), occupied=n_bins,
    )
    np.testing.assert_allclose(rho.double().numpy(), _brute_force(16, dtype), **TOL[dtype])


def _wrapper_args(device="cpu", dtype=torch.float32):
    _, grid, cl, _, n_bins, _ = _cell_list(8, dtype)
    tables = tn.binned_sweep_inputs(grid, cl, n_bins)
    to = lambda t: None if t is None else t.to(device)
    return [to(t) for t in cl.sorted_positions + tables], grid.dims


def test_wrapper_refuses_a_wrong_dtype():
    args, dims = _wrapper_args()
    half = [a.half() if i < 3 else a for i, a in enumerate(args)]
    with pytest.raises(TypeError, match="dtype"):
        sk.binned_sweep_cuda(*half, 8, dims, H)
    ranks32 = list(args)
    ranks32[3] = ranks32[3].int()
    with pytest.raises(TypeError, match="bin_rank dtype"):
        sk.binned_sweep_cuda(*ranks32, 8, dims, H)


def test_wrapper_refuses_non_contiguous_inputs():
    args, dims = _wrapper_args()
    strided = list(args)
    strided[0] = torch.stack([args[0], args[0]], 1)[:, 0]
    assert not strided[0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        sk.binned_sweep_cuda(*strided, 8, dims, H)
    strided = list(args)
    strided[5] = torch.stack([args[5], args[5]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        sk.binned_sweep_cuda(*strided, 8, dims, H)


def test_wrapper_refuses_an_unsupported_device():
    args, dims = _wrapper_args(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.binned_sweep_cuda(*args, 8, dims, H)


def test_wrapper_counts_its_launches():
    assert sk.binned_sweep_cuda in sk.WRAPPERS
    before = sk.binned_sweep_cuda.launches
    args, dims = _wrapper_args()
    sk.binned_sweep_cuda(*args, 8, dims, H)  # the plain version: no launch
    assert sk.binned_sweep_cuda.launches == before
    assert sk.captured_counts()["binned_sweep_cuda"] == sk.binned_sweep_cuda.captured


@pytest.mark.card
def test_kernel_matches_plain_version_on_the_card():
    """K5 against its plain version on the same inputs. The kernel forms q
    as sqrt(d2) * (2/h) and scales by sigma once; the plain version takes q
    = (r + r) / h, scales every term and sums the K slots of a bin in
    torch's reduction order: each term differs by a few units in the last
    place, over up to a few hundred terms (f32 rtol 2e-5 / atol 1e-5, f64
    rtol 1e-10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tol = {torch.float32: dict(rtol=2e-5, atol=1e-5), torch.float64: dict(rtol=1e-10, atol=0)}
    for dtype in (torch.float32, torch.float64):
        for K_cloud, K, cut in ((16, 16, 0), (16, 8, 0), (24, 24, 0), (8, 8, 7), (16, 16, 9)):
            _, grid, cl, _, n_bins, _ = _cell_list(K_cloud, dtype)
            for rank_table in (True, False):
                tables = list(tn.binned_sweep_inputs(grid, cl, n_bins - cut))
                if not rank_table:
                    tables[3] = None
                args = list(cl.sorted_positions) + tables
                want = sk.binned_sweep_cuda(*args, K, grid.dims, H)
                before = sk.binned_sweep_cuda.launches
                got = sk.binned_sweep_cuda(
                    *[None if a is None else a.to(dev) for a in args], K, grid.dims, H
                )
                torch.cuda.synchronize()
                assert sk.binned_sweep_cuda.launches == before + 1
                np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol[dtype])
