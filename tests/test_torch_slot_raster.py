"""Kernel K6, the slot raster of the dense route
(``ops.splat_kernels.slot_raster_cuda``), and its plain version.

On the CPU the wrapper runs the plain version (the reference's rounds of a
scatter-max per slot; ``tests/test_torch_global_sweep.py`` and
``test_torch_cellraster.py`` hold it to the JAX package). Here a numpy
emulation of the kernel's three passes, with the claim pass's atomics taken
in a random interleaving, is held bit for bit to the plain version on
scenes whose cells hold 0-4 particles, with particles off the grid and on
cell boundaries, for 1, 2 and 4 slots, the whole grid and x bands, with and
without the slot meta. On a card (``-m card``; this file imports no JAX, so
``python -m pytest --noconftest -m card tests/test_torch_slot_raster.py``
runs it there) the kernel is held bit for bit to the plain version, once
under CUDA graph capture."""

import fractions
import functools

import numpy as np
import pytest
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.ops import global_sweep as gs
from splashsurf_tpu_torch.ops import splat_kernels as sk
from splashsurf_tpu_torch.uniform_grid import UniformGrid

GRID = UniformGrid(min=(-0.3, 0.1, 0.25), cell_size=0.07, n_cells=(9, 7, 6))
PAD = 2
N = 1001  # not a multiple of the kernel's 256-thread blocks
EMPTY = 2**32 - 1
# x bands (W, x0): the whole grid, one inside it, one at each end
BANDS = {"grid": (None, 0), "inner": (3, 4), "first": (2, 0), "last": (2, 7)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _scene(dtype, seed=5):
    """N particles in random order: 0-4 in each cell of GRID, some on cell
    boundaries, the rest off the grid on every side; weights in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    nc = np.asarray(GRID.n_cells)
    counts = rng.choice(5, size=tuple(nc), p=[0.3, 0.3, 0.2, 0.1, 0.1])
    cells = np.repeat(np.argwhere(counts >= 0), counts.reshape(-1), axis=0)
    inside = GRID.min + (cells + rng.uniform(0.0, 1.0, cells.shape)) * GRID.cell_size
    edge = GRID.min + rng.integers(0, nc + 1, (40, 3)) * GRID.cell_size
    extent = nc * GRID.cell_size
    off = GRID.min + rng.uniform(0.0, 1.0, (N, 3)) * extent
    axis, side = rng.integers(0, 3, N), rng.integers(0, 2, N)
    rows = np.arange(N)
    off[rows, axis] = (np.asarray(GRID.min)[axis] + side * extent[axis]
                       + (2 * side - 1) * rng.uniform(0.01, 0.2, N))
    pts = np.concatenate([inside, edge, off])[:N]
    assert len(inside) + len(edge) < N  # some land off the grid
    pts = pts[rng.permutation(N)]
    t = torch.as_tensor(pts).to(dtype)
    return t, torch.as_tensor(rng.uniform(0.5, 2.0, N)).to(dtype)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _assert_same(got, want):
    """The wrapper's (rasters, over, meta) bit for bit."""
    (gr, go, gm), (wr, wo, wm) = got, want
    assert len(gr) == len(wr)
    for a, b in zip(gr, wr):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(_bits(a.cpu()), _bits(b.cpu()))
    assert torch.equal(go.cpu(), wo.cpu())
    assert (gm is None) == (wm is None)
    for a, b in zip(gm or (), wm or ()):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def _grid_coords(T, nc):
    """g(c) = mn + c cs rounded once, for c in [-1, nc + 1], per axis: in
    float32 formed in float64, in float64 the exact value rounded (a fused
    multiply-add)."""
    out = []
    cs = T(GRID.cell_size)
    for d in range(3):
        mn = T(GRID.min[d])
        c = np.arange(-1, nc[d] + 2)
        if T == np.float32:
            out.append((np.float64(mn) + c.astype(np.float64) * np.float64(cs)).astype(T))
        else:
            exact = [fractions.Fraction(int(v)) * fractions.Fraction(float(cs))
                     + fractions.Fraction(float(mn)) for v in c]
            out.append(np.asarray([float(e) for e in exact], T))
    return out


def _emulate(positions, values, slots, band, with_meta, seed):
    """K6 in numpy as ``csrc/slot_raster.cu`` computes it, its claim pass's
    atomics taken one at a time in a random interleaving."""
    rng = np.random.default_rng(seed)
    pos = positions.numpy()
    T = pos.dtype.type
    n = len(pos)
    nc = np.asarray(GRID.n_cells)
    W, x0 = band
    W = nc[0] if W is None else W
    Xp, Yp, Zp = W + 2 * PAD, nc[1] + 2 * PAD, nc[2] + 2 * PAD
    ncells = Xp * nc[1] * nc[2]
    mn = np.asarray([T(v) for v in GRID.min], T)
    q = np.floor((pos - mn) / T(GRID.cell_size))
    cell = np.clip(q, -1, nc).astype(np.int64)
    tx = cell[:, 0] - x0 + PAD
    valid = ((cell >= 0) & (cell < nc)).all(1) & (tx >= 0) & (tx < Xp)
    entry = np.where(valid, (tx * nc[1] + cell[:, 1]) * nc[2] + cell[:, 2], -1)

    # 1. claim: each valid particle's cascade of atomicMin, interleaved; the
    # index that leaves the last slot is flagged
    tables = np.full(slots * ncells, EMPTY, np.int64)
    over = np.zeros(n, bool)
    state = {int(i): [0, int(i)] for i in np.flatnonzero(valid)}
    while state:
        i = list(state)[rng.integers(len(state))]
        k, v = state[i]
        a = k * ncells + entry[i]
        old = tables[a]
        tables[a] = min(old, v)
        state[i] = [k + 1, max(old, v)]
        if old == EMPTY:
            del state[i]
        elif k + 1 == slots:
            over[max(old, v)] = True
            del state[i]
    # 2. rank (the meta)
    rank = np.full(n, slots, np.int64)
    for k in reversed(range(slots)):
        hit = valid & (tables[k * ncells + np.maximum(entry, 0)] == np.arange(n))
        rank[hit] = k
    # 3. raster: row (k, x, y) and z as the kernel indexes them
    rows = np.arange(slots * Xp * Yp)
    y, x, k = rows % Yp, rows // Yp % Xp, rows // Yp // Xp
    ty, tz = y - PAD, np.arange(Zp) - PAD
    cells_here = ((ty >= 0) & (ty < nc[1]))[:, None] & ((tz >= 0) & (tz < nc[2]))[None, :]
    trow = k * ncells + (x * nc[1] + ty) * nc[2] - PAD
    flat = np.clip(trow[:, None] + np.arange(Zp)[None, :], 0, len(tables) - 1)
    idx = np.where(cells_here, tables[flat], EMPTY)
    placed = idx != EMPTY
    g = _grid_coords(T, nc)
    cx = np.broadcast_to((x + x0 - PAD)[:, None], idx.shape)
    cy = np.broadcast_to(ty[:, None], idx.shape)
    cz = np.broadcast_to(tz[None, :], idx.shape)
    far = T(kernels.far_fill(positions.dtype))
    p = pos[np.where(placed, idx, 0)]
    rasters = [
        np.where(placed, p[..., d] - g[d][np.clip(c, -1, nc[d] + 1) + 1], far).astype(T)
        for d, c in enumerate((cx, cy, cz))
    ]
    if not with_meta:
        rasters.append(np.where(placed, values.numpy()[np.where(placed, idx, 0)], T(0)))
    shape = (slots, Xp, Yp, Zp)
    rasters = tuple(torch.as_tensor(r.reshape(shape)) for r in rasters)
    meta = None
    if with_meta:
        ok = valid & (rank < slots)
        meta = tuple(torch.as_tensor(np.ascontiguousarray(a))
                     for a in (rank, ok, cell[:, 0], cell[:, 1], cell[:, 2]))
    return rasters, torch.as_tensor(over), meta


@pytest.mark.parametrize("with_meta", [False, True], ids=["rasters", "meta"])
@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("slots", [1, 2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulated_kernel_equals_plain_version(dtype, slots, band, with_meta):
    pos, val = _scene(DTYPES[dtype])
    W, x0 = BANDS[band]
    want = sk.slot_raster_cuda(pos, val, GRID, slots, PAD, W, x0, with_meta)
    if slots < 4:
        assert want[1].any()  # the scene's fullest cells overflow
    for seed in range(2):  # two interleavings of the claim pass's atomics
        _assert_same(_emulate(pos, val, slots, BANDS[band], with_meta, seed), want)


def test_scene_covers_the_cases():
    """Cells of 0-4 particles (and more), particles off the grid on both sides of
    every axis and exactly on cell boundaries."""
    pos, val = _scene(torch.float32)
    _, _, (_, _, *cell) = sk.slot_raster_cuda(pos, val, GRID, 2, PAD, with_meta=True)
    c = torch.stack(cell, 1)
    nc = torch.tensor(GRID.n_cells)
    valid = ((c >= 0) & (c < nc)).all(1)
    flat = ((c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2])[valid]
    assert {0, 1, 2, 3, 4} <= set(torch.bincount(flat, minlength=int(nc.prod())).tolist())
    for d in range(3):
        assert (c[:, d] < 0).any() and (c[:, d] >= nc[d]).any()
    mn = torch.tensor([kernels.rounded(v, torch.float32) for v in GRID.min])
    frac = (pos - mn) / kernels.rounded(GRID.cell_size, torch.float32)
    assert (frac == torch.floor(frac)).any()


def test_overflow_list_is_ascending_at_capacity():
    """``rasterize_global``'s overflow list on the planned capacity: the
    overflowed particles in ascending index, then far padding; the true
    count as a device scalar."""
    pos, val = _scene(torch.float32)
    hsc = PAD - 1
    _, overflow, n_over = gs.rasterize_global(pos, val, GRID, 2, hsc, 64)
    _, over, _ = sk.slot_raster_cuda(pos, val, GRID, 2, PAD)
    idx = torch.nonzero(over).squeeze(1)
    assert isinstance(n_over, torch.Tensor) and int(n_over) == idx.numel() > 0
    k = min(64, idx.numel())
    assert torch.equal(overflow[0][:k], pos[idx[:k], 0])
    assert torch.equal(overflow[3][:k], val[idx[:k]])
    assert bool((overflow[0][k:] == -1e30).all()) and bool((overflow[3][k:] == 0).all())


def test_rasterize_global_goes_through_the_wrapper(monkeypatch):
    calls = []
    real = gs.slot_raster_cuda

    def spy(*args):
        calls.append(args[0].device.type)
        return real(*args)

    monkeypatch.setattr(gs, "slot_raster_cuda", spy)
    pos, val = _scene(torch.float64)
    gs.rasterize_global(pos, val, GRID, 2, PAD - 1)
    gs.rasterize_global(pos, None, GRID, 2, PAD - 1, with_meta=True)
    assert calls == ["cpu", "cpu"]


def test_wrapper_refuses_a_wrong_dtype():
    pos, val = _scene(torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        sk.slot_raster_cuda(pos.half(), val.half(), GRID, 2, PAD)
    with pytest.raises(TypeError, match="values dtype"):
        sk.slot_raster_cuda(pos, val.double(), GRID, 2, PAD)


def test_wrapper_refuses_non_contiguous_inputs():
    pos, val = _scene(torch.float32)
    strided = pos.t().contiguous().t()
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        sk.slot_raster_cuda(strided, val, GRID, 2, PAD)
    with pytest.raises(ValueError, match="contiguous"):
        sk.slot_raster_cuda(pos, torch.stack([val, val], 1)[:, 0], GRID, 2, PAD)
    with pytest.raises(ValueError, match="shape"):
        sk.slot_raster_cuda(pos[:, :2].contiguous(), val, GRID, 2, PAD)


def test_wrapper_refuses_an_unsupported_device():
    pos, val = _scene(torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.slot_raster_cuda(pos.to("meta"), val.to("meta"), GRID, 2, PAD)


def test_wrapper_counts_its_launches():
    assert sk.slot_raster_cuda in sk.WRAPPERS
    before = sk.slot_raster_cuda.launches
    pos, val = _scene(torch.float32)
    sk.slot_raster_cuda(pos, val, GRID, 2, PAD)  # the plain version: no launch
    gs.rasterize_global(pos, val, GRID, 2, PAD - 1)
    assert sk.slot_raster_cuda.launches == before
    assert sk.captured_counts()["slot_raster_cuda"] == sk.slot_raster_cuda.captured


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_kernel_equals_plain_version_on_the_card(monkeypatch):
    """K6 against its plain version on the CPU, bit for bit: f32 and f64,
    1, 2 and 4 slots, every band, with and without the meta, and through
    ``rasterize_global`` (which must never take the plain version for a
    CUDA tensor) with its overflow list at capacity."""
    dev = _card()
    for dtype in DTYPES.values():
        pos, val = _scene(dtype)
        for slots in (1, 2, 4):
            for W, x0 in BANDS.values():
                for with_meta in (False, True):
                    want = sk.slot_raster_cuda(pos, val, GRID, slots, PAD, W, x0, with_meta)
                    before = sk.slot_raster_cuda.launches
                    got = sk.slot_raster_cuda(pos.to(dev), val.to(dev), GRID, slots, PAD, W, x0,
                                              with_meta)
                    torch.cuda.synchronize()
                    assert sk.slot_raster_cuda.launches == before + 1
                    _assert_same(got, want)
        want = gs.rasterize_global(pos, val, GRID, 2, PAD - 1, 64)

        def refuse(*_args, **_kw):
            raise AssertionError("the plain raster ran for a CUDA tensor")

        with monkeypatch.context() as m:
            m.setattr(sk, "slot_raster_plain", refuse)
            got = gs.rasterize_global(pos.to(dev), val.to(dev), GRID, 2, PAD - 1, 64)
        for a, b in zip(got[0] + got[1] + (got[2],), want[0] + want[1] + (want[2],)):
            assert torch.equal(_bits(a.cpu()), _bits(b))


@pytest.mark.card
def test_kernel_under_graph_capture_on_the_card():
    """One launch queued while the stream is captured counts in
    ``captured``; the graph's replay gives the plain version's bits."""
    dev = _card()
    pos, val = _scene(torch.float32)
    want = sk.slot_raster_cuda(pos, val, GRID, 2, PAD)
    pos, val = pos.to(dev), val.to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sk.slot_raster_cuda(pos, val, GRID, 2, PAD)  # warm: build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches, captured = sk.slot_raster_cuda.launches, sk.slot_raster_cuda.captured
    with torch.cuda.graph(graph):
        got = sk.slot_raster_cuda(pos, val, GRID, 2, PAD)
    assert (sk.slot_raster_cuda.launches, sk.slot_raster_cuda.captured) == (
        launches, captured + 1)
    for r in got[0]:
        r.fill_(7.0)  # the replay must write every entry
    graph.replay()
    torch.cuda.synchronize()
    _assert_same(got, want)
