"""Kernel K4's walk (``csrc/pair_sweep.cu``) and the distance cut of K2 and
K4, on the CPU.

The fraction masks' plain version is held to numpy's own bit packing. A
numpy emulation of the CUDA kernel's index arithmetic (tiles of 4 x 8 rows
of 32 z cells from shifted origins, the staged window of mask words with
zeros off the raster, the block-wide skip of a source slot, the query
list built from popcounts and one prefix scan, each run's window row, bit
position, bit mask and flat raster offset, the funnel over two staged
words, the walk of set bits in slot -> run -> ascending o2 order, the cut
before the square root) is held to ``pair_sweep_plain``, which the JAX
``_pair_sweep_xla`` holds in ``test_torch_pair_sweep.py``. The cut's
exactness is checked on pairs placed on both sides of the support radius.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.ops import splat_kernels as sk

F32_TOL = dict(rtol=2e-5, atol=1e-5)  # the reference's kernel-vs-scan bar
F64_TOL = dict(rtol=1e-12, atol=1e-14)
TOL = {np.float32: F32_TOL, np.float64: F64_TOL}
FAR = {np.float32: np.inf, np.float64: 1e15}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("Zp", [45, 64, 70])
def test_fraction_masks_match_packbits(dtype, Zp):
    """Occupied is exactly fraction < 1e14: the f32 inf and the f64 1e15
    sentinels, 1e14 itself and NaN are empty; 0 and 9.9e13 are not."""
    rng = np.random.default_rng(Zp)
    fx = rng.uniform(0.0, 0.04, (2, 3, 4, Zp)).astype(dtype)
    fx[rng.uniform(size=fx.shape) < 0.6] = FAR[dtype]
    fx[1, 2, 3, : 6] = [0.0, 1e14, 9.9e13, np.nan, 1e15, np.inf]
    got = sk.occupancy_masks_plain(torch.as_tensor(fx), fractions=True)
    occ = np.zeros(fx.shape[:-1] + (-(-Zp // 32) * 32,), np.uint8)
    occ[..., :Zp] = fx < 1e14
    want = np.ascontiguousarray(np.packbits(occ, axis=-1, bitorder="little"))
    np.testing.assert_array_equal(got.numpy(), want.view("<u4").view(np.int32))
    assert got.numpy().view(np.uint32)[1, 2, 3, 0] & 0b111111 == 0b000101
    before = sk.occupancy_masks_cuda.launches
    assert torch.equal(sk.occupancy_masks_cuda(torch.as_tensor(fx), fractions=True), got)
    assert sk.occupancy_masks_cuda.launches == before  # the plain version, uncounted


def _emulate(fx, fy, fz, cs, h, reach, h_over_cs, pad, n_cells, shift):
    """The CUDA pair sweep's arithmetic in numpy, over rasters (S, Xp, Yp,
    Zp). Tiles of PAIR_TILE cover the cells from origins shifted down by
    ``shift`` (so that no origin is a multiple of the tile size, and the
    window's first bit moves through its word); every query of every tile
    runs at once as one element of a vector. Returns the sums (empty query
    slots 0) and the number of pairs each query visited."""
    T = fx.dtype.type
    S, Xp, Yp, Zp = fx.shape
    ncx, ncy, ncz = n_cells
    TX, TY, TZ = sk.PAIR_TILE
    R = reach
    masks = sk.occupancy_masks_plain(torch.as_tensor(fx), fractions=True).numpy().view(np.uint32)
    W = masks.shape[-1]
    runs = sk.pair_runs(R, h_over_cs)
    assert (runs[:, 3] - runs[:, 2]).max() <= 2 * R + 1 <= 32
    nww = sk.pair_window_words(R)
    wx, wy = TX + 2 * R, TY + 2 * R

    x0, y0, z0 = (a.ravel() for a in np.meshgrid(
        np.arange(-shift[0], ncx, TX), np.arange(-shift[1], ncy, TY),
        np.arange(-shift[2], ncz, TZ), indexing="ij"))
    n_tiles = x0.size
    X0, Y0, Z0 = x0 + pad - R, y0 + pad - R, z0 + pad - R
    w0, zoff = Z0 >> 5, Z0 & 31
    # the staged window: (tile, slot, x row, y row, word), zeros off the raster
    X = (X0[:, None] + np.arange(wx))[:, None, :, None, None]
    Y = (Y0[:, None] + np.arange(wy))[:, None, None, :, None]
    Wd = (w0[:, None] + np.arange(nww))[:, None, None, None, :]
    ok = (X >= 0) & (X < Xp) & (Y >= 0) & (Y < Yp) & (Wd >= 0) & (Wd < W)
    at = (np.arange(S)[None, :, None, None, None], np.clip(X, 0, Xp - 1),
          np.clip(Y, 0, Yp - 1), np.clip(Wd, 0, W - 1))
    win = np.where(ok, masks[at], 0).astype(np.uint64)
    slot_any = win.reshape(n_tiles, S, -1).any(-1)

    def funnel(words, p):
        """32 bits from bit p on of a staged row (..., nww), p < 32 (nww - 1)."""
        lo = np.take_along_axis(words, (p >> 5)[..., None], -1)[..., 0]
        hi = np.take_along_axis(words, (p >> 5)[..., None] + 1, -1)[..., 0]
        return ((lo | hi << np.uint64(32)) >> (p & 31).astype(np.uint64)) & np.uint64(0xFFFFFFFF)

    # the query bits of each (tile, slot, row), cut to the grid's cells
    xl, yl = np.arange(TX)[:, None], np.arange(TY)[None, :]
    qrows = win[:, :, R : R + TX, R : R + TY, :]  # (tile, slot, TX, TY, nww)
    qbits = funnel(qrows, np.broadcast_to((zoff + R)[:, None, None, None], qrows.shape[:-1]))
    zl = np.arange(32)
    zin = (z0[:, None] + zl >= 0) & (z0[:, None] + zl < ncz)
    zvalid = (zin.astype(np.uint64) << zl.astype(np.uint64)).sum(1)
    xyin = ((x0[:, None, None] + xl >= 0) & (x0[:, None, None] + xl < ncx)
            & (y0[:, None, None] + yl >= 0) & (y0[:, None, None] + yl < ncy))
    qbits = np.where(xyin[:, None], qbits & zvalid[:, None, None, None], 0)
    qbits = qbits.reshape(n_tiles, S * TX * TY)  # (slot, row) in list order

    # the query list: each (slot, row)'s place from one exclusive scan
    cnt = np.bitwise_count(qbits).astype(np.int64)
    first = np.cumsum(cnt, axis=1) - cnt
    set_ = (qbits[:, :, None] >> zl.astype(np.uint64)) & np.uint64(1)
    qt, qr, qz = np.nonzero(set_)  # ordered by tile, then slot -> row -> z
    place = np.arange(qt.size) - np.concatenate([[0], np.cumsum(cnt.sum(1))])[qt]
    below = np.bitwise_count(qbits[qt, qr] & ((np.uint64(1) << qz.astype(np.uint64)) - np.uint64(1)))
    np.testing.assert_array_equal(place, first[qt, qr] + below)
    qs, row = qr // (TX * TY), qr % (TX * TY)
    qxl, qyl = row // TY, row % TY
    x, y, z = x0[qt] + qxl, y0[qt] + qyl, z0[qt] + qz
    assert (fx[qs, x + pad, y + pad, z + pad] < 1e14).all()
    assert qt.size == int((fx[(slice(None),) + tuple(slice(pad, pad + n) for n in n_cells)] < 1e14).sum())

    flat = [a.reshape(-1) for a in (fx, fy, fz)]
    slot_stride = Xp * Yp * Zp
    cell = ((x + pad) * Yp + (y + pad)) * Zp + (z + pad)
    qx, qy, qz_ = (a[qs * slot_stride + cell] for a in flat)
    cs_t, two_over_h = T(cs), T(T(2.0) / T(h))
    cut2 = T(sk.support_cut2(h, fx.dtype))
    acc = np.zeros(qt.size, T)
    visited = np.zeros(qt.size, np.int64)
    zb = zoff[qt] + qz
    for k in range(S):
        active = slot_any[qt, k]
        for o0, o1, lo, hi in runs.tolist():
            # the run's staged row relative to the query's, its bit mask, its
            # flat raster offset from the query
            rowk = win[qt, k, qxl + o0 + R, qyl + o1 + R]  # (query, nww)
            bits = funnel(rowk, zb + lo + R) & np.uint64((1 << (hi - lo)) - 1)
            bits = np.where(active, bits, np.uint64(0))
            offset = (o0 * Yp + o1) * Zp + lo
            while bits.any():
                sel = np.nonzero(bits)[0]
                b = bits[sel]
                bit = np.bitwise_count((b & (~b + np.uint64(1))) - np.uint64(1)).astype(np.int64)
                bits[sel] = b & (b - np.uint64(1))
                i = k * slot_stride + cell[sel] + offset + bit
                sx, sy, sz = (a[i] for a in flat)
                e = (k, x[sel] + pad + o0, y[sel] + pad + o1, z[sel] + pad + lo + bit)
                np.testing.assert_array_equal(sx, fx[e])
                assert (sx < 1e14).all()
                visited[sel] += 1
                dx = qx[sel] - (sx + T(o0) * cs_t)
                dy = qy[sel] - (sy + T(o1) * cs_t)
                dz = qz_[sel] - (sz + (lo + bit).astype(T) * cs_t)
                d2 = dx * dx + dy * dy + dz * dz
                q = np.sqrt(d2) * two_over_h
                a = np.maximum(T(2) - q, T(0))
                c = np.maximum(T(1) - q, T(0))
                term = a * a * a - T(4) * (c * c * c)
                under = d2 <= cut2
                assert (term[~under] == 0).all()  # the cut skips exact zeros only
                acc[sel] = np.where(under, acc[sel] + term, acc[sel])
    out = np.zeros((S,) + tuple(n_cells), T)
    out[qs, x, y, z] = acc * T(1.0 / (4.0 * np.pi))
    count = np.zeros((S,) + tuple(n_cells), np.int64)
    count[qs, x, y, z] = visited
    return out, count


def _scene(dtype, reach, kind, seed):
    """Fraction rasters (2, Xp, Yp, Zp) of cells (9, 11, 45) with pad =
    reach + 1, h/cs below reach: slot 0 dense, slot 1 sparse, an entry in
    each corner of the padded raster and of the grid's cells; or slot 1
    alone; and pairs placed at d = h (1 +- 1e-3, 1e-6) across the support."""
    rng = np.random.default_rng(seed)
    cs = 0.04
    h_over_cs = {2: 1.9, 3: 8 / 3}[reach]
    h = cs * h_over_cs
    pad = reach + 1
    n_cells = (9, 11, 45)
    shape = (2,) + tuple(n + 2 * pad for n in n_cells)
    fr = rng.uniform(0, cs, (3,) + shape).astype(dtype)
    occ = np.zeros(shape, bool)
    if kind == "slot 1 alone":
        occ[1] = rng.uniform(size=shape[1:]) < 0.3
    else:
        occ[0] = rng.uniform(size=shape[1:]) < 0.3
        occ[1] = rng.uniform(size=shape[1:]) < 0.05
        for i in (0, pad, shape[1] - pad - 1, shape[1] - 1):
            for j in (0, pad, shape[2] - pad - 1, shape[2] - 1):
                for k in (0, pad, shape[3] - pad - 1, shape[3] - 1):
                    occ[:, i, j, k] = True
    fr[:, ~occ] = FAR[dtype]
    if kind == "across the support":
        eps = (1e-3, -1e-3, 1e-6, -1e-6)
        placed = 0
        for n in range(60):
            c0 = np.array([pad + n % 9, pad + 1 + n % 9, pad + 2 + (7 * n) % 41])
            f0 = rng.uniform(0.3 * cs, 0.7 * cs, 3)
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            p = c0 * cs + f0 + h * (1 + eps[n % 4]) * u
            c = np.floor(p / cs).astype(int)
            if (c < pad).any() or (c >= np.array(shape[1:]) - pad).any():
                continue
            fr[:, 0][(slice(None),) + tuple(c0)] = f0
            fr[:, 1][(slice(None),) + tuple(c)] = p - c * cs
            placed += 1
        assert placed > 30
    return fr, cs, h, h_over_cs, pad, n_cells


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reach", [2, 3])
@pytest.mark.parametrize("kind", ["dense", "slot 1 alone", "across the support"])
def test_walk_reproduces_pair_sweep_plain(dtype, reach, kind):
    """The emulated walk against the plain sweep on occupied query slots
    (0 on the empty ones), each query visiting exactly its occupied fan
    pairs, with tile origins on and off the tile grid."""
    fr, cs, h, h_over_cs, pad, n_cells = _scene(dtype, reach, kind, seed=reach)
    want = sk.pair_sweep_plain(*map(torch.as_tensor, fr), cs, h, reach, h_over_cs, pad,
                               n_cells).numpy()
    inner = (slice(None),) + tuple(slice(pad, pad + n) for n in n_cells)
    occ = fr[0][inner] < 1e14
    # the occupied pairs of each query in the fan, counted directly
    src = (fr[0] < 1e14).sum(0)
    pairs = np.zeros(n_cells, np.int64)
    for o in sk.pair_cell_offsets(reach, h_over_cs):
        pairs += src[tuple(slice(pad + a, pad + a + n) for a, n in zip(o, n_cells))]
    assert want[occ].max() > 0.1
    for shift in ((0, 0, 0), (1, 3, 7), (2, 5, 20)):
        got, count = _emulate(*fr, cs, h, reach, h_over_cs, pad, n_cells, shift)
        np.testing.assert_allclose(got[occ], want[occ], **TOL[dtype])
        assert (got[~occ] == 0).all()
        np.testing.assert_array_equal(count, np.where(occ, pairs[None], 0))


@pytest.mark.parametrize("source, tile, words, fn", [
    ("level_set_sum.cuh", sk.SWEEP_TILE, sk.window_words, "window_words"),
    ("pair_sweep.cu", sk.PAIR_TILE, sk.pair_window_words, "pair_window_words"),
])
def test_host_geometry_matches_the_kernel_source(source, tile, words, fn):
    """The emulations above and in test_torch_sweep_occupancy.py read the
    host's copies of the tile and of the staged words per window row; they
    must be the kernel's own (parsed from its source: kTileX, kTileY, tiles
    of 32 z, and the words function for every pad or reach a launch takes)."""
    text = (Path(sk.__file__).resolve().parent.parent / "csrc" / source).read_text()
    tx, ty = (int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
              for k in ("kTileX", "kTileY"))
    assert tile == (tx, ty, 32)
    assert re.search(r"\+ 31\) / 32\)", text)  # the launch's tiles of 32 z
    arg, expr = re.search(rf"int {fn}\(int (\w+)\) \{{\s*return ([^;]+);", text).groups()
    for v in range(16):
        assert words(v) == eval(expr, {}, {arg: v})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps", [1e-7, 1e-5, 1e-3])
def test_cut_skips_only_exact_zeros(dtype, eps):
    """Pairs at d = h (1 +- eps), in the raster form of both kernels (a
    query fraction against a source fraction plus its cell offset): every
    pair with d2 > support_cut2 has a term of exactly +0 in K4's
    arithmetic (``pair_sweep_plain``: q = sqrt(d2) * (2/h)) and in K2's
    (``cubic_kernel``: q = (r + r) / h); within the 1e-4 slack of the cut no
    pair is skipped, and past it every one is. The same holds at the first
    d2 above the cut."""
    rng = np.random.default_rng(int(1 / eps))
    t = np.dtype(dtype).type
    for h in (0.044, 0.1, 1.7e-3, 3.0):
        cs = h / 2.67
        n = 4000
        f0 = rng.uniform(0, cs, (n, 3))
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        p = f0 + (h * (1 + sign * eps))[:, None] * u
        cell = np.floor(p / cs)
        fs = (p - cell * cs).astype(dtype)
        diff = [f0[:, d].astype(dtype) - (fs[:, d] + t(cell[:, d]) * t(cs)) for d in range(3)]
        d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        cut2 = t(sk.support_cut2(h, torch.float32 if dtype == np.float32 else torch.float64))
        d2 = np.concatenate([d2, np.nextafter(cut2, t(np.inf), dtype=dtype)[None]])
        skipped = d2 > cut2
        if eps < 1e-4:
            assert skipped.sum() == 1  # only the first d2 above the cut
        else:
            np.testing.assert_array_equal(skipped[:-1], sign > 0)
        q = np.sqrt(d2) * (t(2.0) / t(h))
        a = np.maximum(t(2) - q, t(0))
        c = np.maximum(t(1) - q, t(0))
        k4 = a * a * a - t(4) * (c * c * c)
        assert (k4[skipped] == 0).all() and not np.signbit(k4[skipped]).any()
        k2 = kernels.cubic_kernel(torch.sqrt(torch.as_tensor(d2)), h).numpy()
        assert (k2[skipped] == 0).all() and not np.signbit(k2[skipped]).any()
