"""The occupancy masks and the bit walk of the level-set sweep kernels K1
and K3 (``csrc/level_set_sum.cuh``), on the CPU.

The masks' plain version is held to numpy's own bit packing. A numpy
emulation of the CUDA kernel's index arithmetic (tiles of 2 x 4 rows of
32 z, the staged window of mask words with zeros off the raster, the
block-wide slot skip, each run's window row, bit mask and flat raster
offset, the funnel over two staged words, the walk of set bits in slot ->
run -> ascending o2 order) is held to the plain sweeps
``sweep_global_plain`` and ``splat_sweep_plain``, which the JAX scan holds
in ``test_torch_global_sweep.py`` and ``test_torch_subdomains.py``."""

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch.ops import splat_kernels as sk

F32_TOL = dict(rtol=2e-5, atol=1e-5)  # the reference's kernel-vs-scan bar
F64_TOL = dict(rtol=1e-12, atol=1e-14)
TOL = {np.float32: F32_TOL, np.float64: F64_TOL}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packbits_words(fv: np.ndarray) -> np.ndarray:
    """numpy's little-endian bit packing of (fv != 0) per row, as int32 words."""
    Zp = fv.shape[-1]
    W = -(-Zp // 32)
    occ = np.zeros(fv.shape[:-1] + (32 * W,), np.uint8)
    occ[..., :Zp] = fv != 0
    packed = np.packbits(occ, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("Zp", [64, 65, 72, 112])
def test_masks_match_packbits(dtype, Zp):
    rng = np.random.default_rng(Zp)
    fv = rng.uniform(0.5, 1.0, (3, 5, 4, Zp)).astype(dtype)
    fv[rng.uniform(size=fv.shape) < 0.7] = 0.0
    fv[0] = 0.0  # an empty slot
    fv[1] = rng.uniform(0.5, 1.0, fv[1].shape)  # a full slot
    fv[2, :, :] = 0.0
    for z in (0, 31, 32, 63, Zp - 1):  # word edges and the row's last entry
        fv[2, 1, 2, z] = 1.0
    got = sk.occupancy_masks_plain(torch.as_tensor(fv))
    assert got.dtype == torch.int32 and got.shape == fv.shape[:-1] + (-(-Zp // 32),)
    np.testing.assert_array_equal(got.numpy(), _packbits_words(fv))
    words = got.numpy().view(np.uint32)
    assert (words[0] == 0).all()
    assert (words[1, ..., : Zp // 32] == 0xFFFFFFFF).all()
    row = words[2, 1, 2]
    assert row[0] == (1 | 1 << 31) and row[1] & 1 and row[1] >> 31 & 1
    assert row[(Zp - 1) // 32] >> ((Zp - 1) % 32) & 1


def test_masks_mean_a_nonzero_weight():
    """Occupied is exactly v != 0: the f64 empty slot (weight 0 beside the
    1e15 fraction) and -0.0 are empty, a tiny or negative weight is not;
    the wrapper takes the plain version on a CPU tensor, uncounted."""
    fv = torch.tensor([[0.0, -0.0, 1e-300, -2.0, 0.0, 5.0]], dtype=torch.float64)
    before = sk.occupancy_masks_cuda.launches
    assert sk.occupancy_masks_cuda(fv).tolist() == [[0b101100]]
    assert sk.occupancy_masks_cuda.launches == before
    with pytest.raises(TypeError):
        sk.occupancy_masks_cuda(fv.to(torch.int32))
    with pytest.raises(ValueError):
        sk.occupancy_masks_cuda(torch.zeros((4, 6)).t())
    with pytest.raises(ValueError, match="unsupported device"):
        sk.occupancy_masks_cuda(torch.empty((2, 6), device="meta"))


def test_split_runs_keeps_the_order():
    runs = np.array([[0, 1, 0, 70], [0, 2, 3, 5]], np.int32)
    np.testing.assert_array_equal(
        sk.split_runs(runs),
        [[0, 1, 0, 32], [0, 1, 32, 64], [0, 1, 64, 70], [0, 2, 3, 5]],
    )
    for hsc in (1, 2, 3, 8):
        r = sk.offset_runs(hsc)
        np.testing.assert_array_equal(sk.split_runs(r), r)  # all within 32


@pytest.mark.parametrize("hsc,h_over_cs,kept", [(3, 4 / 1.5, 160), (3, 3.0, 232), (2, 2.0, 88),
                                                (3, 2.85, None), (1, 0.5, None)])
def test_sweep_runs_drop_only_cells_beyond_the_support(hsc, h_over_cs, kept):
    """The kernels' run table is the fan in its own order less the cells
    whose nearest point lies beyond the support radius (by 0.1 %), whose
    terms are exactly 0; at the canyon parameters (support 4r, cube 1.5r)
    that is 160 of 232 offsets."""
    pad = hsc + 1
    full = sk.offset_runs(hsc, pad)
    runs = sk.sweep_runs(hsc, pad, h_over_cs)
    offs = lambda rr: [(a, b, c) for a, b, lo, hi in rr.tolist() for c in range(lo, hi)]
    kept_offs, all_offs = offs(runs), offs(full)
    assert kept_offs == [o for o in all_offs if o in set(kept_offs)]  # a subsequence
    if kept is not None:
        assert len(kept_offs) == kept
    for o in set(all_offs) - set(kept_offs):
        d = [a if a > 0 else (-(a + 1) if a + 1 < 0 else 0) for a in np.subtract(o, pad)]
        assert np.sqrt(np.sum(np.square(d))) >= h_over_cs


def _emulate(fx, fy, fz, fv, cs, h, hsc, pad, n_points, shift):
    """The CUDA sweep's arithmetic in numpy, over rasters (C, S, Xp, Yp, Zp).

    Tiles of SWEEP_TILE cover the points from origins shifted down by
    ``shift`` (so that no origin is a multiple of the tile size); every
    thread of every tile runs at once as one lane of a vector."""
    T = fx.dtype.type
    C, S, Xp, Yp, Zp = fv.shape
    PX, PY, PZ = n_points
    TX, TY, TZ = sk.SWEEP_TILE
    masks = sk.occupancy_masks_plain(torch.as_tensor(fv)).numpy().view(np.uint32)
    W = masks.shape[-1]
    runs = sk.sweep_runs(hsc, pad, h / cs)

    c, x0, y0, z0 = (a.ravel() for a in np.meshgrid(
        np.arange(C), np.arange(-shift[0], PX, TX), np.arange(-shift[1], PY, TY),
        np.arange(-shift[2], PZ, TZ), indexing="ij"))
    n_tiles = c.size
    # the staged window: (tile, slot, x row, y row, word), zeros off the raster
    w0, zoff = z0 >> 5, z0 & 31
    nww = ((zoff + 2 * pad + 30) >> 5) + 2
    assert (nww[zoff == 0] == sk.window_words(pad)).all()
    wx, wy = TX + 2 * pad - 1, TY + 2 * pad - 1
    X = (x0[:, None] + np.arange(wx))[:, None, :, None, None]
    Y = (y0[:, None] + np.arange(wy))[:, None, None, :, None]
    K = np.arange(nww.max())[None, :]
    Wd = (w0[:, None] + K)[:, None, None, None, :]
    ok = (X >= 0) & (X < Xp) & (Y >= 0) & (Y < Yp) & (Wd >= 0) & (Wd < W)
    ok = ok & (K < nww[:, None])[:, None, None, None, :]
    at = (c[:, None, None, None, None], np.arange(S)[None, :, None, None, None],
          np.clip(X, 0, Xp - 1), np.clip(Y, 0, Yp - 1), np.clip(Wd, 0, W - 1))
    win = np.where(ok, masks[at], 0).astype(np.uint64).reshape(n_tiles, S, -1)
    slot_any = win.any(-1)

    # the threads: warp = (x row, y row) of the tile, lane = z
    tid = np.arange(TX * TY * TZ)
    xl, yl, lane = tid // 32 // TY, tid // 32 % TY, tid % 32
    x, y, z = x0[:, None] + xl, y0[:, None] + yl, z0[:, None] + lane
    live = (x >= 0) & (x < PX) & (y >= 0) & (y < PY) & (z >= 0) & (z < PZ)
    zb = zoff[:, None] + lane
    lane_row = (xl * wy + yl) * nww.max()  # the lane's own staged row
    flat = [a.reshape(-1) for a in (fx, fy, fz, fv)]
    cs_t, two_over_h = T(cs), T(2.0 / h)
    acc = np.zeros((n_tiles, tid.size), T)
    for s in range(S):
        active = live & slot_any[:, s][:, None]
        base = (((c[:, None] * S + s) * Xp + x) * Yp + y) * Zp + z  # the point's entry
        for o0, o1, lo, hi in runs.tolist():
            # the staged run: its row in the window relative to the lane's,
            # its bit mask, its flat raster offset from the point
            word = (o0 * wy + o1) * nww.max()
            len_mask = np.uint64((1 << (hi - lo)) - 1)
            offset = (o0 * Yp + o1) * Zp + lo
            p = zb + lo
            w = lane_row + word + (p >> 5)
            pair = (np.take_along_axis(win[:, s], w, -1)
                    | (np.take_along_axis(win[:, s], w + 1, -1) << np.uint64(32)))
            bits = (pair >> (p & 31).astype(np.uint64)) & len_mask
            bits = np.where(active, bits, np.uint64(0))
            # each lane's set bits, lowest first
            while bits.any():
                sel = np.nonzero(bits)
                b = bits[sel]
                k = np.bitwise_count((b & (~b + np.uint64(1))) - np.uint64(1)).astype(np.int64)
                bits[sel] = b & (b - np.uint64(1))
                ex, ey, ez, ev = (a[base[sel] + offset + k] for a in flat)
                # the flat offset lands on the raster entry (x + o0, y + o1, z + o2)
                o2 = lo + k
                e = (c[sel[0]], s, x[sel] + o0, y[sel] + o1, z[sel] + o2)
                np.testing.assert_array_equal(ev, fv[e])
                np.testing.assert_array_equal(ez, fz[e])
                dx = ex + T(o0 - pad) * cs_t
                dy = ey + T(o1 - pad) * cs_t
                dz = ez + (o2 - pad).astype(T) * cs_t
                qq = np.sqrt(dx * dx + dy * dy + dz * dz) * two_over_h
                a = np.maximum(T(2) - qq, T(0))
                bb = np.maximum(T(1) - qq, T(0))
                acc[sel] += (a * a * a - T(4) * (bb * bb * bb)) * ev
    out = np.full((C, PX, PY, PZ), np.nan, T)
    sigma = T(8.0 / h**3 / (4.0 * np.pi))
    out[np.broadcast_to(c[:, None], x.shape)[live], x[live], y[live], z[live]] = acc[live] * sigma
    assert not np.isnan(out).any()
    return out


def _rasters(shape, dtype, rng, fill, cs):
    fr = rng.uniform(0, cs, (3,) + shape).astype(dtype)
    v = rng.uniform(0.5, 1.0, shape).astype(dtype)
    empty = rng.uniform(size=shape) >= fill
    fr[:, empty] = np.inf if dtype == np.float32 else 1e15
    v[empty] = 0.0
    return (*fr, v)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("hsc", [2, 3])
def test_walk_reproduces_sweep_global_plain(dtype, hsc):
    """K1-shaped: (S, Xp, Yp, Zp) with Zp past one word, Xp one wider than
    needed, slot 1 sparser than slot 0, a lone entry in each far corner."""
    rng = np.random.default_rng(hsc)
    pad, cs = hsc + 1, 0.04
    n_points = (5, 6, 37)
    Xp, Yp, Zp = (n + 2 * pad - 1 for n in n_points)
    Xp += 1
    r = list(_rasters((2, Xp, Yp, Zp), dtype, rng, 0.3, cs))
    r[3][1][rng.uniform(size=(Xp, Yp, Zp)) < 0.8] = 0.0
    for corner in ((0, 0, 0), (Xp - 2, Yp - 1, Zp - 1), (0, Yp - 1, Zp - 1)):
        for a in r[:3]:
            a[(1,) + corner] = cs / 3
        r[3][(1,) + corner] = 1.0
    h = cs * hsc * 0.95
    want = sk.sweep_global_plain(*map(torch.as_tensor, r), cs, h, hsc, n_points).numpy()
    assert want.max() > 0.1
    for shift in ((0, 0, 0), (1, 3, 7)):
        got = _emulate(*(a[None] for a in r), cs, h, hsc, pad, n_points, shift)[0]
        np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("hsc", [2, 3])
def test_walk_reproduces_splat_sweep_plain(dtype, hsc):
    """K3-shaped: (C, S, Rp, Rp, Rp), Rp past one word, margin above hsc
    for one of the cases; a sparse sheet in one chunk, slot 1 alone
    occupied in the other, so that most tiles skip a slot or everything."""
    rng = np.random.default_rng(10 + hsc)
    margin = hsc + (hsc == 2)
    pad, cs, P = margin + 1, 0.04, 27
    Rp = P + 2 * pad - 1
    r = list(_rasters((2, 2, Rp, Rp, Rp), dtype, rng, 0.2, cs))
    sheet = np.zeros((Rp, Rp, Rp), bool)
    sheet[:, :, 14:17] = True
    far = np.inf if dtype == np.float32 else 1e15
    for a in r[:3]:
        a[0][:, ~sheet] = far  # chunk 0: the sheet, both slots
        a[1, 0] = far  # chunk 1: slot 1 alone
    r[3][0][:, ~sheet] = 0.0
    r[3][1, 0] = 0.0
    h = cs * hsc * 0.95
    want = sk.splat_sweep_plain(*map(torch.as_tensor, r), cs, h, hsc, margin, P).numpy()
    assert want[0].max() > 0.1 and want[1].max() > 0.1
    for shift in ((0, 0, 0), (1, 2, 5)):
        got = _emulate(*r, cs, h, hsc, pad, (P, P, P), shift)
        np.testing.assert_allclose(got, want, **TOL[dtype])
