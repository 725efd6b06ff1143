"""The subdomain route's streamed mode in the PyTorch port: its mesh is the
resident mode's bit for bit (f32 and f64) on the corners the JAX package's
``tests/test_streaming.py`` covers. The comparison with the JAX package's
own streamed run is in ``test_torch_streaming_reference.py``, the f64
check against the dense route in ``test_torch_cross_route.py``."""

import numpy as np
import pytest
import torch

import bench
from splashsurf_tpu.reconstruction import _bucket_grid, grid_for_reconstruction

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in (ts.STREAM_ENV, ts.STREAM_BUDGET_ENV):
        monkeypatch.delenv(k, raising=False)


R = 0.011


def _forced(radius=R, n_sub=16, dtype="float32", **kw):
    return pt.Parameters.new_relative(
        radius, 4.0, 1.5,
        grid_decomposition=pt.GridDecompositionParameters(n_sub, auto_disable=False), **kw,
    ).try_convert(dtype)


def _grid(pts, params):
    g = _bucket_grid(grid_for_reconstruction(
        pts, params.particle_radius, params.compact_support_radius, params.cube_size))
    return pt.UniformGrid(min=g.min, cell_size=g.cell_size, n_cells=g.n_cells)


def _run(pts, params, monkeypatch, stream, **kw):
    """One subdomain-route run with ``SPLASHSURF_TPU_STREAM`` = ``stream``:
    (result, a copy of ``LAST_RUN``)."""
    monkeypatch.setenv(ts.STREAM_ENV, stream)
    rec = ts.reconstruct_surface_subdomain_grid(
        torch.as_tensor(pts), params, _grid(pts, params), **kw
    )
    run = dict(ts.LAST_RUN)
    assert run["streamed"] == (stream == "1")
    return rec, run


def _closed(mesh):
    return pt.check_mesh_consistency(mesh.vertices, mesh.triangles) is None


def _clump_scene(seed=5):
    """A dam-break block with 400 particles packed into one cell's width:
    many pairs of rank >= 2 take the overflow scatter."""
    pts = bench.make_dam_break(2000, R, seed=seed)
    rng = np.random.default_rng(seed + 1)
    clump = pts[len(pts) // 2] + rng.uniform(-0.3, 0.3, (400, 3)).astype(np.float32) * R
    return np.concatenate([pts, clump]).astype(np.float32)


def _mixed_scene():
    """A dense clump beside a sparse sheet: subdomains of very different
    occupancy, interleaved in id order."""
    sheet = bench.make_canyon(1200, R, seed=3, layers=2)
    block = bench.make_dam_break(500, R, seed=4) * 0.5 + sheet.mean(axis=0)
    return np.concatenate([sheet, block]).astype(np.float32)


SCENES = {"clump": _clump_scene, "mixed": _mixed_scene}


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, make in SCENES.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_streamed_equals_resident(scenes, scene, dtype, monkeypatch):
    pts = scenes[scene].astype(dtype)
    params = _forced(dtype=dtype)
    res, r0 = _run(pts, params, monkeypatch, "0")
    stm, r1 = _run(pts, params, monkeypatch, "1")
    assert r1["B"] == r0["B"] > 4
    assert r1["shell_bytes"] == 6 * r1["B"] * (16 + 1) ** 2 * np.dtype(dtype).itemsize
    if scene == "clump":
        assert r1["raster_overflow"] > 100
    assert stm.mesh.vertices.dtype == np.dtype(dtype)
    assert stm.mesh.num_triangles > 1000 and _closed(stm.mesh)
    np.testing.assert_array_equal(stm.mesh.vertices, res.mesh.vertices)
    np.testing.assert_array_equal(stm.mesh.triangles, res.mesh.triangles)
    for k in ("splat", "halo", "marching cubes", "stitch"):
        assert k in r1["stage_s"] and k in r0["stage_s"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_subdomain_per_chunk(scenes, dtype, monkeypatch):
    """``chunk_bytes=1``: every chunk one subdomain, so every donor lies in
    an earlier chunk; the mesh is the resident one's, and the one-chunk
    streamed run's."""
    pts = scenes["clump"].astype(dtype)
    params = _forced(dtype=dtype)
    res, r0 = _run(pts, params, monkeypatch, "0")
    whole, r1 = _run(pts, params, monkeypatch, "1")
    single, r2 = _run(pts, params, monkeypatch, "1", chunk_bytes=1)
    assert r1["splat_chunks"] == 1
    assert r2["splat_chunks"] == r2["B"] == r0["B"]
    for rec in (whole, single):
        np.testing.assert_array_equal(rec.mesh.vertices, res.mesh.vertices)
        np.testing.assert_array_equal(rec.mesh.triangles, res.mesh.triangles)


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_halo_from_shells_equals_halo_overwrite(chunk):
    """Random level sets on a 3 x 4 x 3 subdomain grid with holes: the
    streamed halo, chunks in ascending id, each writing its raw faces before
    it reads, equals the resident halo bit for bit, corners and edges
    included."""
    rng = np.random.default_rng(chunk)
    P = 5
    sd = ts.initialize_parameters(_forced(n_sub=P - 1), pt.UniformGrid((0.0,) * 3, 0.0165, (12, 16, 12)))
    assert sd.num_subdomains == (3, 4, 3)
    occ = np.sort(rng.choice(36, 27, replace=False))
    ns = sd.num_subdomains
    ijk = np.stack([occ // (ns[1] * ns[2]), (occ // ns[2]) % ns[1], occ % ns[2]], axis=1)
    nb_idx, nb_flat = (torch.as_tensor(t) for t in ts._neighbor_tables(occ, ijk, sd))
    own = torch.as_tensor(occ)
    raw = torch.as_tensor(rng.normal(size=(len(occ), P, P, P)))
    want = ts.halo_overwrite(raw.clone(), own, nb_idx, nb_flat)
    shells = torch.zeros((6, len(occ), P * P), dtype=raw.dtype)
    got = []
    for b0 in range(0, len(occ), chunk):
        b1 = min(b0 + chunk, len(occ))
        ls = raw[b0:b1].clone()
        shells[:, b0:b1] = ts.extract_faces(ls)
        got.append(ts.halo_from_shells(ls, own[b0:b1], nb_idx[:, b0:b1], nb_flat[:, b0:b1], shells))
    got = torch.cat(got)
    assert not torch.equal(want, raw)
    assert torch.equal(got, want)


def test_stream_plan_runs_in_ascending_id():
    """The streamed chunks cut the rows in id order, whatever the
    occupancy (the resident splat plan sorts by occupancy instead)."""
    sd = ts.initialize_parameters(_forced(), pt.UniformGrid((0.0,) * 3, 0.0165, (64, 64, 64)))
    counts = np.random.default_rng(0).integers(1, 5000, 40)
    plan = ts.stream_plan(counts, sd, 4, 5 * 10**6)
    assert len(plan) > 2
    np.testing.assert_array_equal(np.concatenate(plan), np.arange(40))
    assert not np.array_equal(np.concatenate(ts.splat_plan(counts, sd, 4, 5 * 10**6)), np.arange(40))


def test_unreachable_iso_gives_an_empty_mesh(monkeypatch):
    pts = np.random.default_rng(3).uniform(0, 0.2, (500, 3)).astype(np.float32)
    params = _forced(0.02, n_sub=8, iso_surface_threshold=100.0)
    for stream in ("0", "1"):
        rec, run = _run(pts, params, monkeypatch, stream)
        assert run["B"] > 1
        assert rec.mesh.num_triangles == 0 and rec.mesh.num_vertices == 0


def test_streamed_neighborhood_lists(scenes, monkeypatch):
    pts = scenes["clump"]
    params = _forced(global_neighborhood_list=True)
    monkeypatch.setenv(ts.STREAM_ENV, "1")
    rec = pt.reconstruct_surface(pts, params, device="cpu")
    assert ts.LAST_RUN["streamed"] and rec.subdomain_grid is not None
    lists = rec.particle_neighbors
    assert isinstance(lists, pt.NeighborhoodLists) and len(lists) == len(pts)
    want = pt.neighborhood_search_spatial_hashing_parallel(
        torch.as_tensor(pts), params.compact_support_radius
    )
    np.testing.assert_array_equal(lists.offsets, want.offsets)
    np.testing.assert_array_equal(lists.indices, want.indices)
    assert rec.mesh.num_triangles > 1000 and _closed(rec.mesh)
