"""Kernel K2's walk (``csrc/density_sweep.cu``) on the CPU.

The slot bytes' plain version is held to numpy's own bit packing. A numpy
emulation of the CUDA kernel (one lane per (bx, by * Zp + bz) in warps of
32 and blocks of 128, the 8 query slots per lane, the warp-wide skip of
query slots no lane holds, the per-bin slot bytes and the warp's source
slots taken in step, each lane loading only its own occupied sources, the
cut before the square root) is held to ``density_sweep_plain``, which the
JAX ``_raster_sweep_xla`` holds in ``test_torch_densities_raster.py``, on
lattices whose width crosses a block."""

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch.ops import splat_kernels as sk

F32_TOL = dict(rtol=2e-5, atol=1e-5)  # the reference's kernel-vs-scan bar
F64_TOL = dict(rtol=1e-12, atol=1e-14)
TOL = {np.float32: F32_TOL, np.float64: F64_TOL}
FAR = {np.float32: np.inf, np.float64: 1e15}
THREADS = 128  # kThreads of density_sweep.cu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slot_bytes_match_packbits(dtype):
    """Bit k of a bin's byte is set iff slot k's fraction is below 1e14;
    the wrapper takes the plain version on a CPU tensor, uncounted, and
    refuses a raster without 8 slots."""
    rng = np.random.default_rng(3)
    fx = rng.uniform(0.0, 0.05, (8, 4, 5, 6)).astype(dtype)
    fx[rng.uniform(size=fx.shape) < 0.5] = FAR[dtype]
    fx[:, 0, 0, 0] = [0.0, 1e14, 9.9e13, np.nan, 1e15, np.inf, 0.01, FAR[dtype]]
    want = np.packbits((fx < 1e14).astype(np.uint8), axis=0, bitorder="little")[0]
    got = sk.bin_occupancy_plain(torch.as_tensor(fx))
    assert got.dtype == torch.uint8 and got.shape == fx.shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0] == 0b01000101
    before = sk.bin_occupancy_cuda.launches
    assert torch.equal(sk.bin_occupancy_cuda(torch.as_tensor(fx)), got)
    assert sk.bin_occupancy_cuda.launches == before
    with pytest.raises(ValueError, match="slots"):
        sk.bin_occupancy_cuda(torch.as_tensor(fx[:4]).contiguous())


def _emulate(fx, fy, fz, LX, bs, h):
    """The CUDA density sweep's arithmetic in numpy over rasters (8, LX+2,
    Yp, Zp); every lane of the lattice runs at once as one element of a
    vector. Returns the sums (8, LX, W), 0 on empty query slots, and the
    occupied sources each lane loaded."""
    T = fx.dtype.type
    S, Xp, Yp, Zp = fx.shape
    plane, W = Yp * Zp, (Yp - 2) * Zp
    slot_stride = Xp * plane
    n = LX * W
    n_pad = -(-n // THREADS) * THREADS  # whole blocks; the tail lanes idle
    idx = np.arange(n_pad)
    live = idx < n
    warp = idx // 32
    l = np.where(live, idx % W, 0)
    bx = np.where(live, idx // W, 0)
    flat = [a.reshape(S, -1) for a in (fx, fy, fz)]
    occ = sk.bin_occupancy_plain(torch.as_tensor(fx)).numpy().reshape(-1).astype(np.uint32)
    q0 = (bx + 1) * plane + Zp + 1 + l
    q = [f[:, q0] for f in flat]  # (8, lanes)
    qocc = (q[0] < 1e14) & live
    qmask = (qocc.astype(np.uint32) << np.arange(S, dtype=np.uint32)[:, None]).sum(0)
    wmask = np.bitwise_or.reduceat(qmask, np.arange(0, n_pad, 32))[warp]
    cut2 = T(sk.support_cut2(h, fx.dtype))
    two_over_h = T(2.0 / h)
    acc = np.zeros((S, n_pad), T)
    loads = np.zeros(n_pad, np.int64)
    for nb in range(27):
        o0, o1, o2 = nb // 9, nb // 3 % 3, nb % 3
        j = l + o1 * Zp + o2
        src0 = (bx + o0) * plane + j
        b = np.where((qmask != 0) & (j < plane), occ[np.minimum(src0, occ.size - 1)], 0)
        wb = np.bitwise_or.reduceat(b, np.arange(0, n_pad, 32))[warp]
        od = [T(o - 1) * T(bs) for o in (o0, o1, o2)]
        for k in range(S):  # the warp's source slots in step, ascending
            lanes = (wb >> k & 1).astype(bool) & (b >> k & 1).astype(bool)
            src = k * slot_stride + np.where(lanes, src0, 0)
            s_ = [f.reshape(-1)[src] + d for f, d in zip(flat, od)]
            assert (fx.reshape(-1)[src][lanes] < 1e14).all()
            loads += lanes
            for s in range(S):
                with np.errstate(invalid="ignore", over="ignore"):  # inf - inf
                    d = [q[a][s] - s_[a] for a in range(3)]
                    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                    qq = np.sqrt(d2) * two_over_h
                    a = np.maximum(T(2) - qq, T(0))
                    c = np.maximum(T(1) - qq, T(0))
                    term = a * a * a - T(4) * (c * c * c)
                upd = lanes & (wmask >> s & 1).astype(bool) & (d2 <= cut2)
                acc[s] = np.where(upd, acc[s] + term, acc[s])
    sigma = T(8.0 / h**3 / (4.0 * np.pi))
    out = np.where(qocc, acc * sigma, T(0))[:, :n].reshape(S, LX, W)
    return out, loads[:n].reshape(LX, W)


def _lattice(dtype, kind, seed):
    """Bin rasters (8, LX+2, LY+2, LZ+2), bin size h, with W = LY (LZ + 2)
    = 160 lanes: more than one 128-lane block per row. "random": half the
    slots filled; "sparse": the bins of the first six y rows empty, so that
    whole warps hold no query; "straddle": slot 0 of each bin and slot 1 of the next
    bin along x at d = h (1 + eps), eps in +-1e-7, +-1e-5, +-1e-3."""
    rng = np.random.default_rng(seed)
    h = 0.05
    LX, LY, LZ = 4, 10, 14
    shape = (8, LX + 2, LY + 2, LZ + 2)
    far = FAR[dtype]
    fr = rng.uniform(0, h, (3,) + shape)
    if kind == "random":
        fr[:, rng.uniform(size=shape) < 0.5] = far
    elif kind == "sparse":
        fr[:, rng.uniform(size=shape) < 0.3] = far
        fr[:, :, :, :6] = far
    else:
        fr[:] = far
        inner = (slice(1, LX), slice(1, LY + 1), slice(1, LZ + 1))
        nxt = (slice(2, LX + 1), slice(1, LY + 1), slice(1, LZ + 1))
        m = (LX - 1) * LY * LZ
        f0 = rng.uniform(0.25 * h, 0.5 * h, (3, m))
        eps = np.array([1e-7, -1e-7, 1e-5, -1e-5, 1e-3, -1e-3])[np.arange(m) % 6]
        for d in range(3):
            fr[d, 0][inner] = f0[d].reshape(LX - 1, LY, LZ)
            fr[d, 1][nxt] = (f0[d] + (h * eps if d == 0 else 0)).reshape(LX - 1, LY, LZ)
    fr[:, :, [0, -1]] = far
    fr[:, :, :, [0, -1]] = far
    fr[:, :, :, :, [0, -1]] = far
    return LX, h, [np.ascontiguousarray(a.astype(dtype)) for a in fr]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random", "sparse", "straddle"])
def test_walk_reproduces_density_sweep_plain(dtype, kind):
    """The emulated walk against the plain sweep on occupied query slots,
    0 on the empty ones; each lane holding a query loads exactly the
    occupied sources of its 27 neighbour bins, and no other lane loads."""
    LX, h, fr = _lattice(dtype, kind, seed=len(kind))
    want = sk.density_sweep_plain(*map(torch.as_tensor, fr), LX, h, h).numpy()
    got, loads = _emulate(*fr, LX, h, h)
    S, Xp, Yp, Zp = fr[0].shape
    W = (Yp - 2) * Zp
    qocc = fr[0].reshape(S, Xp, Yp * Zp)[:, 1 : 1 + LX, Zp + 1 : Zp + 1 + W] < 1e14
    assert W > THREADS and qocc.sum() > 100 and want[qocc].max() > 1.0
    np.testing.assert_allclose(got[qocc], want[qocc], **TOL[dtype])
    assert (got[~qocc] == 0).all()
    # the occupied sources of each lane's neighbour bins, counted directly
    nocc = (fr[0] < 1e14).sum(0).reshape(Xp, Yp * Zp)
    nocc = np.pad(nocc, ((0, 0), (0, 2)))  # lanes past the plane are empty
    want_loads = sum(nocc[o0 : o0 + LX, o1 * Zp + o2 : o1 * Zp + o2 + W]
                     for o0 in range(3) for o1 in range(3) for o2 in range(3))
    np.testing.assert_array_equal(loads, np.where(qocc.any(0), want_loads, 0))
    if kind == "sparse":
        lanes = qocc.any(0).reshape(-1)
        assert (~lanes.reshape(-1, 32).any(1)).sum() > 0  # whole warps skip
