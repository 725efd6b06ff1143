"""The port's device list, collectives and sharded decomposition, on
virtual CPU shards: ``decompose_sharded`` against the port's single-device
``decompose`` (every subdomain's (pid, cell, rank) segment equal, every pair
on its slab's owner) and against the JAX package's ``decompose_sharded`` on
its own test scene (segments equal as integers)."""

import numpy as np
import pytest
import torch

import splashsurf_tpu as st
from splashsurf_tpu.parallel.decompose import decompose_sharded as jdecompose_sharded
from splashsurf_tpu.parallel.mesh import make_mesh as jmake_mesh
from splashsurf_tpu.params import SpatialDecomposition
from splashsurf_tpu.reconstruction import grid_for_reconstruction as jgrid_for_reconstruction
from splashsurf_tpu.subdomains import initialize_parameters as jinitialize_parameters

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.parallel import mesh as pm
from splashsurf_tpu_torch.parallel.decompose import decompose_sharded, split_decomposition
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.025


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_devices():
    """Every test leaves the process's default device list behind."""
    yield
    pm.set_devices(None)


def _cpu_mesh(D):
    pm.set_devices(["cpu"] * D)
    return pm.make_mesh(device="cpu")


# --- the device list and the collectives ------------------------------------


def test_default_lists_hold_one_cpu_and_the_visible_cards():
    assert pm.devices("cpu") == [torch.device("cpu")]
    assert len(pm.devices("cuda")) == torch.cuda.device_count()
    assert pm.make_mesh(device="cpu").size == 1


def test_set_devices_installs_virtual_shards_and_restores():
    mesh = _cpu_mesh(8)
    assert mesh.size == 8 and mesh.axis_name == "sub"
    assert pm.make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    pm.set_devices(None)
    assert pm.make_mesh(device="cpu").size == 1


def test_a_list_of_another_kind_raises():
    pm.set_devices(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="cuda, not cpu"):
        pm.devices("cpu")
    with pytest.raises(ValueError, match="cuda, not cpu"):
        pt.reconstruct_surface(np.zeros((4, 3)), pt.Parameters.new_relative(R, 4.0, 1.5),
                               device="cpu")
    for bad in ([], ["cpu", "cuda:0"], ["cuda"]):
        with pytest.raises(ValueError):
            pm.set_devices(bad)


def test_collectives_receive_fresh_buffers():
    """On virtual shards ``x.to(device)`` is ``x``: whatever a shard
    receives must be a new tensor, so that writing it leaves the sender's
    buffer alone."""
    mesh = _cpu_mesh(3)
    parts = [torch.arange(4) + 10 * d for d in range(3)]
    buckets = [[torch.full((s + 1,), 10 * s + d) for d in range(3)] for s in range(3)]
    got = pm.all_to_all(buckets, mesh)
    for d in range(3):
        np.testing.assert_array_equal(got[d], np.concatenate([np.full(s + 1, 10 * s + d)
                                                              for s in range(3)]))
    one = pm.all_to_all([[buckets[0][0]]], pm.make_mesh(1, device="cpu"))[0]
    one += 1
    assert buckets[0][0].tolist() == [0]
    gathered = pm.all_gather(parts, mesh)
    assert all(torch.equal(g, torch.cat(parts)) for g in gathered)
    gathered[0] += 100
    assert parts[0].tolist() == [0, 1, 2, 3]
    assert [int(x) for x in pm.psum([torch.tensor(d) for d in range(3)], mesh)] == [3, 3, 3]
    assert [int(x) for x in pm.pmax([torch.tensor(d) for d in (2, 7, 5)], mesh)] == [7, 7, 7]
    assert pm.blocks(10, 3) == [(0, 4), (4, 8), (8, 10)]
    assert pm.blocks(2, 3) == [(0, 1), (1, 2), (2, 2)]


# --- the sharded decomposition -----------------------------------------------


def _scene(nx=30, ny=8, nz=8, seed=0):
    """``tests/test_parallel_decompose.py``'s scene."""
    rng = np.random.default_rng(seed)
    return (
        np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T * 2 * R
        + rng.uniform(-0.2, 0.2, (nx * ny * nz, 3)) * 2 * R
    ).astype(np.float32)


def _sd(pts, n_sub=None):
    kw = {} if n_sub is None else dict(grid_decomposition=pt.GridDecompositionParameters(n_sub))
    params = pt.Parameters.new_relative(R, 4.0, 1.5, **kw)
    grid = pt.grid_for_reconstruction(torch.as_tensor(pts), R, params.compact_support_radius,
                                      params.cube_size)
    return ts.initialize_parameters(params, grid)


def _segments(shards):
    """{subdomain: (pids, cells, ranks)} over the shards, which must hold
    ascending ids in device order."""
    segs, last = {}, -1
    for s in shards:
        for i, st_, c in zip(s["occ_ids"], s["starts"], s["counts"]):
            assert i > last
            last = i
            segs[int(i)] = tuple(s[k][st_ : st_ + c].numpy() for k in ("pids", "cells", "ranks"))
    return segs


def _single(pts, sd, nv=None):
    t, p, c, r = ts.decompose(torch.as_tensor(pts[:nv]), sd)
    ids, starts, counts = ts.occupied_segments(t)
    return dict(pids=p, cells=c, ranks=r, occ_ids=ids, starts=starts, counts=counts)


@pytest.mark.parametrize(
    "D, n_sub, nv",
    [(8, None, None), (8, 8, None), (3, 8, None), (5, 8, 4321)],
    ids=["8 shards, 64-cell subdomains", "8 shards, 8-cell", "3 shards", "5 shards, dummies"],
)
def test_segments_equal_the_single_device_segments(D, n_sub, nv):
    pts = _scene(64, 12, 12, seed=3)
    sd = _sd(pts, n_sub)
    mesh = _cpu_mesh(D)
    out = decompose_sharded(torch.as_tensor(pts), sd, mesh, n_valid=nv)
    single = _single(pts, sd, nv)
    assert out["D"] == D and out["slab_w"] == -(-sd.num_subdomains[0] // D)
    assert out["n_pairs"] == single["pids"].shape[0] == sum(
        s["pids"].shape[0] for s in out["shards"])
    ns = sd.num_subdomains
    for d, s in enumerate(out["shards"]):
        owner = np.minimum(s["occ_ids"] // (ns[1] * ns[2]) // out["slab_w"], D - 1)
        assert (owner == d).all()
        assert s["counts"].sum() == s["pids"].shape[0]
        if nv is not None:
            assert bool((s["pids"] < nv).all())
    want = _segments([single])
    got = _segments(out["shards"])
    assert got.keys() == want.keys() and len(want) >= 2
    for sub, segs in want.items():
        for a, b in zip(got[sub], segs):
            np.testing.assert_array_equal(a, b)
    # the replicated decomposition cut into the same slabs
    split = split_decomposition(single, sd, mesh)
    assert [len(s["occ_ids"]) for s in split] == [len(s["occ_ids"]) for s in out["shards"]]
    assert _segments(split).keys() == want.keys()
    for sub, segs in _segments(split).items():
        for a, b in zip(segs, want[sub]):
            np.testing.assert_array_equal(a, b)


def test_segments_equal_the_reference_sharded_decomposition():
    """The JAX package's ``decompose_sharded`` on its own test scene, 8
    devices on both sides: the same subdomains, segments equal as integers."""
    pts = _scene()
    jp = st.Parameters.new_relative(
        R, 4.0, 1.5, spatial_decomposition=SpatialDecomposition.UNIFORM_GRID)
    jsd = jinitialize_parameters(jp, jgrid_for_reconstruction(
        pts, R, jp.compact_support_radius, jp.cube_size))
    ref = jdecompose_sharded(pts, jsd, jmake_mesh())
    sd = _sd(pts)
    assert sd.num_subdomains == tuple(jsd.num_subdomains)
    out = decompose_sharded(torch.as_tensor(pts), sd, _cpu_mesh(8))
    assert out["n_pairs"] == ref["n_pairs"]
    D, Lp = ref["D"], ref["Lp"]
    cols = {k: np.asarray(ref[k]).reshape(D, Lp) for k in ("pid_s", "cell_s", "rank_s")}
    want = {}
    for d in range(D):
        for b in range(int(ref["n_occ_d"][d])):
            s, c = int(ref["starts"][d, b]), int(ref["counts"][d, b])
            want[int(ref["occ"][d, b])] = tuple(cols[k][d, s : s + c]
                                                for k in ("pid_s", "cell_s", "rank_s"))
    got = _segments(out["shards"])
    assert got.keys() == want.keys()
    for sub, segs in want.items():
        for a, b in zip(got[sub], segs):
            np.testing.assert_array_equal(a, b.astype(np.int64))
