"""The encoded mesh pull of the PyTorch port against the JAX package's, on
seeded level sets at small sizes, in f32 and f64:

- the dense route's streams: ``mc_global_cells(encode=True, quant_t=...)``
  gives the reference's ``packed``, ``bincl`` and totals exactly, and its
  ``t`` exactly (the same arithmetic on the same values, quantized or not);
  with ``own_px`` too (a slab's owned points);
- the host decoders: the port's native ``mc_decode``, ``mc_decode_sub`` and
  ``unpack_compact`` against the reference's native ones on the same
  streams, and against the port's numpy decoders; int64 point ids past
  2^31;
- the decoded mesh is ``mc_global_cells``' unencoded mesh (triangles equal,
  vertices within the host's missing multiply-add, or cell_size / 65535 *
  1.01 with u16 t, the reference's own bar,
  ``tests/test_reconstruct_global.py:469-470``);
- the subdomain route's owned-point streams (``chunk_mc_counts_encoded``,
  ``chunk_mc_encode``) against the reference's;
- edge-major marching cubes (``mc_global_packed``, with and without
  ``encode``) and its numpy decoder against the reference's;
- the switches: ``pull_mode``, ``use_encoded_pull`` and
  ``enable_profile_sync``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from splashsurf_tpu import native as jnative
from splashsurf_tpu import subdomains as jsub
from splashsurf_tpu.ops import global_sweep as jgs
from splashsurf_tpu.uniform_grid import UniformGrid as JGrid

from splashsurf_tpu_torch import native, plans, subdomains
from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.uniform_grid import UniformGrid

ISO = 0.6
CS = 0.05
MIN = (0.1, -0.2, 0.3)
CAP = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(shape, dtype, seed):
    """A noisy blob and a second one cut by the far x plane: a level set on
    grid points whose surface reaches the grid's boundary planes."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape], indexing="ij")
    c = [s / 2 for s in shape]
    blob = 1.0 - np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (min(shape) / 2.5)
    edge = 1.0 - np.sqrt((x - shape[0] + 1) ** 2 + (y - 2) ** 2 + (z - 2) ** 2) / 2.5
    return (np.maximum(blob, edge) + rng.uniform(-0.3, 0.3, shape)).astype(dtype)


def _grids(shape):
    cells = tuple(s - 1 for s in shape)
    return (UniformGrid(min=MIN, cell_size=CS, n_cells=cells),
            JGrid(min=MIN, cell_size=CS, n_cells=cells))


def _streams(ls, quant, own_px=None):
    """Both packages' encoded streams of ``ls`` at capacity ``CAP``, as numpy
    (t, packed, bincl, total_v, total_t, total_c)."""
    tg, jg = _grids(ls.shape)
    kw = {} if own_px is None else dict(own_px=own_px)
    got = tgs.mc_global_cells(torch.as_tensor(ls), tg, ISO, CAP, CAP, encode=True,
                              quant_t=quant, **kw)
    want = jgs.mc_global_cells(jnp.asarray(ls), jg, jnp.asarray(ISO, ls.dtype), CAP, CAP,
                               encode=True, quant_t=quant,
                               **({} if own_px is None else dict(own_px=jnp.int32(own_px))))
    unpack = lambda s: [np.asarray(a) for a in s[:3]] + [int(a) for a in s[3:]]
    return [a.numpy() if isinstance(a, torch.Tensor) and a.ndim else int(a) for a in got], unpack(
        want)


# (dtype, quant_t, shape, seed, own_px)
STREAM_CASES = [
    ("float32", False, (13, 11, 9), 0, None),
    ("float32", True, (13, 11, 9), 0, None),
    ("float64", False, (13, 11, 9), 0, None),
    ("float32", True, (20, 9, 12), 1, None),
    ("float64", False, (20, 9, 12), 1, None),
    ("float32", False, (20, 9, 12), 1, 14),
]


@pytest.mark.parametrize("dtype, quant, shape, seed, own_px", STREAM_CASES)
def test_dense_streams_equal_the_reference(dtype, quant, shape, seed, own_px):
    ls = _field(shape, np.dtype(dtype), seed)
    got, want = _streams(ls, quant, own_px)
    tv, tt, tc = want[3:]
    assert got[3:] == [tv, tt, tc] and tt > 50
    assert got[0].dtype == want[0].dtype == (np.uint16 if quant else np.dtype(dtype))
    np.testing.assert_array_equal(got[0][:tv], want[0][:tv])
    assert got[1].dtype == want[1].dtype == np.uint16
    np.testing.assert_array_equal(got[1], want[1])  # zero past total_c in both
    assert got[2].dtype == want[2].dtype == np.uint8
    np.testing.assert_array_equal(got[2], want[2])


def test_exact_streams_without_capacities():
    """Without capacities the streams have their exact sizes and equal the
    capacity run's prefix."""
    ls = _field((13, 11, 9), np.float32, 0)
    tg, _ = _grids(ls.shape)
    x = torch.as_tensor(ls)
    exact = tgs.mc_global_cells(x, tg, ISO, encode=True, quant_t=True)
    capped = tgs.mc_global_cells(x, tg, ISO, CAP, CAP, encode=True, quant_t=True)
    tv, tt, tc = (int(a) for a in exact[3:])
    assert exact[0].shape[0] == tv and exact[1].shape[0] == tc
    assert [int(a) for a in capped[3:]] == [tv, tt, tc]
    for a, b in zip(exact[:3], capped[:3]):
        assert torch.equal(a, b[: a.shape[0]])


def _port_decode(t, packed, bincl, tv, tt, tc, grid):
    return tgs.decode_encoded(t, packed, bincl, tv, tt, tc, grid)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_decoder_matches_the_reference_and_numpy(quant, seed):
    ls = _field((13, 11, 9) if seed == 0 else (20, 9, 12), np.float32, seed)
    (t, packed, bincl, tv, tt, tc), _ = _streams(ls, quant)
    tg, jg = _grids(ls.shape)
    before = dict(native.DECODE_STATS)
    v, tris = _port_decode(t, packed, bincl, tv, tt, tc, tg)
    assert native.DECODE_STATS["native"] == before["native"] + 1
    assert v.dtype == np.float32 and tris.dtype == np.int32
    # the reference's native decoder on the same streams
    rp, rw = jgs._unpack_compact(packed, bincl, tc)
    rv, rt = jnative.mc_decode(jgs._dequant_t(t[:tv]), rp, rw, tv, tt, tc,
                               tg.n_points[1], tg.n_points[2], MIN, CS)
    np.testing.assert_array_equal(tris, rt)
    np.testing.assert_array_equal(v, rv)
    # the port's numpy decoder
    p64, w = tgs._unpack_compact(packed, bincl, tc)
    nv, nt = tgs._decode_cellwise_mesh(tgs._dequant_t(t[:tv]), p64, w, tv, tt, tc, tg)
    np.testing.assert_array_equal(nt, tris)
    np.testing.assert_allclose(nv, v, rtol=0, atol=1e-6)
    # the unencoded mesh of the same level set
    uv, ut = tgs.mc_global_cells(torch.as_tensor(ls), tg, ISO)
    np.testing.assert_array_equal(tris, ut.numpy())
    tol = CS / 65535 * 1.01 if quant else 1e-6
    assert np.abs(v - uv.numpy()).max() <= tol


def test_f64_streams_decode_in_numpy():
    ls = _field((13, 11, 9), np.float64, 2)
    (t, packed, bincl, tv, tt, tc), want = _streams(ls, False)
    tg, jg = _grids(ls.shape)
    before = dict(native.DECODE_STATS)
    v, tris = _port_decode(t, packed, bincl, tv, tt, tc, tg)
    assert native.DECODE_STATS["numpy"] == before["numpy"] + 1
    assert v.dtype == np.float64
    rp, rw = jgs._unpack_compact(want[1], want[2], tc)
    rv, rt = jgs._decode_cellwise_mesh(want[0], rp, rw, tv, tt, tc, jg)
    np.testing.assert_array_equal(tris, rt)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12)
    uv, ut = tgs.mc_global_cells(torch.as_tensor(ls), tg, ISO)
    np.testing.assert_array_equal(tris, ut.numpy())
    np.testing.assert_allclose(v, uv.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("offset", [0, 7777, 2**31 + 5, 2**40])
def test_unpack_compact_matches_the_reference_with_int64_ids(offset):
    ls = _field((20, 9, 12), np.float32, 1)
    (_, packed, bincl, _, _, tc), _ = _streams(ls, False)
    p, w = native.unpack_compact(packed, bincl, tc, point_offset=offset)
    assert p.dtype == np.int64 and w.dtype == np.uint16 and len(p) == tc
    rp, rw = jgs._unpack_compact(packed, bincl, tc)  # int32 ids, no offset
    np.testing.assert_array_equal(p, rp.astype(np.int64) + offset)
    np.testing.assert_array_equal(w, rw)
    np.testing.assert_array_equal(p, tgs._unpack_compact(packed, bincl, tc, offset)[0])
    if offset < 2**31 - 2**20:
        jp, jw = jnative.unpack_compact(packed, bincl, tc, point_offset=offset)
        np.testing.assert_array_equal(p, jp)
    assert (np.diff(p) > 0).all()
    with pytest.raises(RuntimeError):
        native.unpack_compact(packed, bincl, tc - 1)


def _sub_chunk(dtype, seed, C=3, P=9):
    """A (C, P, P, P) chunk of subdomain level sets cut from one field, the
    blocks' shared planes equal (as the halo leaves them), and their
    subdomain coordinates. The field is 0 on its boundary planes, as a
    level set is within the grid's support margin: no subdomain beyond it
    owns an active edge."""
    n = P - 1
    ls = _field((C * n + 1, P, P), np.dtype(dtype), seed)
    for a in range(3):
        ls[(slice(None),) * a + (0,)] = ls[(slice(None),) * a + (-1,)] = 0
    blocks = np.stack([ls[c * n : c * n + P] for c in range(C)])
    sub_ijk = np.stack([np.arange(C), np.zeros(C, int), np.zeros(C, int)], 1)
    return blocks, sub_ijk, ls


def _sd(P, shape):
    n = P - 1
    g = UniformGrid(min=MIN, cell_size=CS, n_cells=tuple(s - 1 for s in shape))
    sg = UniformGrid(min=MIN, cell_size=CS * n, n_cells=tuple(-(-(s - 1) // n) for s in shape))
    return subdomains.SubdomainGridParams(g, sg, n, 2)


def _jsd(sd):
    j = lambda g: JGrid(min=g.min, cell_size=g.cell_size, n_cells=g.n_cells)
    return jsub.SubdomainGridParams(j(sd.global_grid), j(sd.subdomain_grid), sd.n_sub,
                                    sd.margin_cells)


@pytest.mark.parametrize("dtype, quant", [("float32", False), ("float32", True),
                                          ("float64", False)])
def test_owned_point_streams_equal_the_reference(dtype, quant):
    blocks, sub_ijk, full = _sub_chunk(dtype, 3)
    sd = _sd(blocks.shape[1], full.shape)
    x = torch.as_tensor(blocks)
    counts = [c.numpy() for c in subdomains.chunk_mc_counts_encoded(x, sd, ISO)]
    want = [np.asarray(c) for c in jsub.chunk_mc_counts_encoded(
        jnp.asarray(blocks), _jsd(sd), jnp.asarray(ISO, blocks.dtype))]
    for a, b in zip(counts, want):
        np.testing.assert_array_equal(a, b)
    packed, t, cnt, total_v = subdomains.chunk_mc_encode(x, sd, ISO, CAP, CAP, quant_t=quant)
    jp, jt, jc, jtv = jsub.chunk_mc_encode(jnp.asarray(blocks), _jsd(sd),
                                           jnp.asarray(ISO, blocks.dtype), CAP, CAP,
                                           quant_t=quant)
    assert packed.dtype == torch.uint32 and int(total_v) == int(jtv) == counts[1].sum()
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    # exact sizes without capacities
    ep, et, _, _ = subdomains.chunk_mc_encode(x, sd, ISO, quant_t=quant)
    assert ep.shape[0] == counts[0].sum() and et.shape[0] == int(total_v)
    assert torch.equal(ep, packed[: ep.shape[0]]) and torch.equal(et, t[: et.shape[0]])


@pytest.mark.parametrize("dtype, quant", [("float32", False), ("float32", True),
                                          ("float64", False)])
def test_subdomain_decoders_match_the_reference(dtype, quant):
    blocks, sub_ijk, full = _sub_chunk(dtype, 4)
    sd = _sd(blocks.shape[1], full.shape)
    ns = sd.n_sub
    ap, oe, tc = (c.numpy() for c in subdomains.chunk_mc_counts_encoded(
        torch.as_tensor(blocks), sd, ISO))
    order = subdomains.encoded_run_order(ap, oe, tc)
    packed, t, _, _ = subdomains.chunk_mc_encode(torch.as_tensor(blocks[order]), sd, ISO,
                                                 quant_t=quant)
    packed, t = packed.numpy(), t.numpy()
    run_base = sub_ijk[order] * ns
    total_v, total_t = int(oe.sum()), int(tc.sum())
    g = sd.global_grid
    got = subdomains._decode_encoded_streams(packed, t, ap[order], run_base, ns, g,
                                             torch.float32 if dtype == "float32" else
                                             torch.float64, quant, total_v, total_t)
    npv, npt = subdomains._decode_sub_mesh_np(packed, t, ap[order], run_base, ns, g, quant)
    jg = _jsd(sd).global_grid
    rnv, rnt = jsub._decode_sub_mesh_np(packed, t, ap[order], run_base, ns, jg, quant)
    np.testing.assert_array_equal(npt, rnt)
    np.testing.assert_array_equal(npv, rnv)
    np.testing.assert_array_equal(got[1], npt)
    if dtype == "float32":
        rv, rt = jnative.mc_decode_sub(t, packed, ap[order], run_base, total_v, total_t, ns,
                                       g.n_points[1], g.n_points[2], MIN, CS, quant)
        np.testing.assert_array_equal(got[1], rt)
        np.testing.assert_array_equal(got[0], rv)
        assert np.abs(got[0] - npv).max() <= 1e-6
    # the same surface as the whole field's marching cubes: equal counts and
    # the same vertex set
    uv, ut = tgs.mc_global_cells(torch.as_tensor(full), g, ISO)
    assert got[1].shape == tuple(ut.shape)
    tol = CS / 65535 * 1.01 if quant else 1e-6
    assert np.abs(np.sort(got[0], axis=0) - np.sort(uv.numpy(), axis=0)).max() <= tol


def test_compact_streams_reorders_runs():
    """Packs computed one row at a time in descending row order, empty rows
    included, regathered into the load order, equal the packs computed in
    that order."""
    blocks, _, full = _sub_chunk("float32", 5, C=4)
    sd = _sd(blocks.shape[1], full.shape)
    x = torch.as_tensor(blocks)
    ap, oe, tc = (c.numpy() for c in subdomains.chunk_mc_counts_encoded(x, sd, ISO))
    order = subdomains.encoded_run_order(ap, oe, tc)
    stream = np.arange(4)[::-1].copy()
    assert len(order) >= 2 and len(order) < 4
    packs = [subdomains.chunk_mc_encode(x[[r]], sd, ISO)[:2] for r in stream]
    got = subdomains._compact_streams(packs, order, stream, ap, oe)
    want = subdomains.chunk_mc_encode(x[torch.as_tensor(order)], sd, ISO)[:2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("encode", [False, True])
def test_edge_major_mc_equals_the_reference(dtype, encode):
    ls = _field((13, 11, 9), np.dtype(dtype), 6)
    tg, jg = _grids(ls.shape)
    got = tgs.mc_global_packed(torch.as_tensor(ls), tg, ISO, CAP, CAP, encode=encode)
    want = jgs.mc_global_packed(jnp.asarray(ls), jg, jnp.asarray(ISO, ls.dtype), CAP, CAP,
                                encode=encode)
    if encode:
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert [int(a) for a in got[4:]] == [int(a) for a in want[4:]]
        tv, tt, tc = (int(a) for a in got[4:])
        v, t = tgs._decode_packed_mesh(*(a.numpy() for a in got[:4]), tv, tt, tc, tg)
        rv, rt = jgs._decode_packed_mesh(*(np.asarray(a) for a in want[:4]), tv, tt, tc, jg)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(v, rv)
        return
    nv, nt = int(want[6]), int(want[7])
    assert (int(got[2]), int(got[3])) == (nv, nt) and nt > 50
    rv = np.stack([np.asarray(a)[:nv] for a in want[:3]], 1)
    rt = np.stack([np.asarray(a)[:nt] for a in want[3:6]], 1)
    np.testing.assert_array_equal(got[1].numpy()[:nt], rt)
    np.testing.assert_allclose(got[0].numpy()[:nv], rv, rtol=0, atol=0)
    # the cell-major mesh of the same level set: the same lists
    cv, ct = tgs.mc_global_cells(torch.as_tensor(ls), tg, ISO)
    ev, et, _, _ = tgs.mc_global_packed(torch.as_tensor(ls), tg, ISO)
    assert torch.equal(et, ct) and torch.equal(ev, cv)


@pytest.mark.parametrize("env, want", [
    ({}, (False, False, False)),
    ({"SPLASHSURF_TPU_PULL": "encoded"}, (False, True, True)),
    ({"SPLASHSURF_TPU_PULL": "encoded", "SPLASHSURF_TPU_PULL_QUANT": "0"}, (False, True, False)),
    ({"SPLASHSURF_TPU_PULL_QUANT": "1"}, (False, False, False)),
    ({"SPLASHSURF_TPU_PULL": "encoded", "SPLASHSURF_TPU_MC": "edges"}, (True, False, False)),
])
def test_pull_mode_reads_the_reference_switches(env, want, monkeypatch):
    for k in ("SPLASHSURF_TPU_PULL", "SPLASHSURF_TPU_PULL_QUANT", "SPLASHSURF_TPU_MC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tgs.pull_mode(torch.float32) == want
    assert tgs.pull_mode(torch.float64) == want[:2] + (False,)  # u16 t only in f32


@pytest.mark.parametrize("n_sub, env, want", [
    (16, None, False), (16, "1", True), (16, "0", False), (128, "1", True), (129, "1", False),
])
def test_subdomain_encoded_gate(n_sub, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", raising=False)
    else:
        monkeypatch.setenv("SPLASHSURF_TPU_SUB_ENCODED_PULL", env)
    sd = subdomains.SubdomainGridParams(None, None, n_sub, 2)
    assert subdomains.use_encoded_pull(sd) is want


def test_enable_profile_sync_toggles_the_flag():
    assert subdomains._PROFILE_SYNC is False  # the reference's default
    try:
        subdomains.enable_profile_sync()
        assert subdomains._PROFILE_SYNC is True
        subdomains.enable_profile_sync(False)
        assert subdomains._PROFILE_SYNC is False
    finally:
        subdomains.enable_profile_sync(False)
    assert jsub._PROFILE_SYNC is False


def test_the_encoded_pull_names_are_ported():
    """The names of the encoded pull, once in the parity test's
    ``NOT_PORTED``, on their port modules with the reference's signatures
    (the parity test holds the parameters)."""
    for mod, names in ((native, ("mc_decode", "mc_decode_sub", "unpack_compact")),
                       (subdomains, ("chunk_mc_counts_encoded", "chunk_mc_encode",
                                     "enable_profile_sync")),
                       (tgs, ("mc_global_packed", "_pack_cellwise",
                              "_pack_encoded", "_decode_packed_mesh", "_decode_cellwise_mesh",
                              "_unpack_compact", "_dequant_t")),
                       (plans, ("PULL_PLAN_ENC",))):
        for name in names:
            assert hasattr(mod, name), name
    assert native.load_decoder() is not None  # g++ builds it here
