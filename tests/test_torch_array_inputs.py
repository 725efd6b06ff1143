"""Array-like inputs under the port's device rule, and the members of the
pysplashsurf-parity value types.

The cases come from a walk of the JAX package's source: every public
function or method (``__init__`` included) whose body applies
``jnp.asarray`` or ``jnp.array`` to one of its parameters takes
array-likes there, less the TPU-only ``ops.prefix`` and ``ops.splat_pallas``
modules. For each, the port's counterpart is called twice on the CPU with
the same seeded inputs: once with CPU tensors, once with every tensor
argument a numpy array (walked scalars as 0-d arrays), both with
``device="cpu"``; the results must be equal bit for bit, dtypes included,
in float32 and float64. A call made of arrays only and no ``device=``
raises RuntimeError where CUDA is absent: there is no CPU fallback. The
tensor calls themselves are held against the JAX package by the other
test files. Then ``Aabb3d``, ``UniformGrid`` and ``Parameters.np_dtype``
are held against the reference on seeded inputs, as ``tests/test_core.py``
holds the reference's own."""

from __future__ import annotations

import ast
import dataclasses
import functools
import importlib
import inspect
import pathlib
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

import splashsurf_tpu as st

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import kernels as tk
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch import placement
from splashsurf_tpu_torch import subdomains as ts
from splashsurf_tpu_torch.mc import dense as tmc
from splashsurf_tpu_torch.ops import global_sweep as tgs
from splashsurf_tpu_torch.ops import slab_sweep as tslab
from splashsurf_tpu_torch.parallel import mesh as pm
from splashsurf_tpu_torch.reconstruction import grid_for_reconstruction
from splashsurf_tpu_torch.uniform_grid import kernel_extents
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)
from torch_meshes import icosphere

ROOT = pathlib.Path(__file__).resolve().parent.parent
SKIPPED_MODULES = ("ops.prefix", "ops.splat_pallas")
# Walked functions that the port leaves tensor-only, each with its reason.
ARRAY_INPUT_NOT_PORTED: dict = {}
DTYPES = {"f32": np.float32, "f64": np.float64}
R = 0.01  # particle radius


def _walk() -> dict:
    """{"module:qualname": walked parameter names} of the JAX package."""
    out = {}
    for path in sorted((ROOT / "splashsurf_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "splashsurf_tpu").with_suffix("").as_posix()
        rel = rel.replace("/", ".")
        if rel.startswith(SKIPPED_MODULES):
            continue

        def visit(body, prefix):
            for node in body:
                if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    visit(node.body, f"{prefix}{node.name}.")
                elif isinstance(node, ast.FunctionDef) and (
                    not node.name.startswith("_") or (prefix and node.name == "__init__")
                ):
                    a = node.args
                    params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs} - {"self"}
                    hits = {
                        c.args[0].id for c in ast.walk(node)
                        if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                        and c.func.attr in ("asarray", "array")
                        and isinstance(c.func.value, ast.Name) and c.func.value.id == "jnp"
                        and c.args and isinstance(c.args[0], ast.Name) and c.args[0].id in params
                    }
                    if hits:
                        out[f"{rel}:{prefix}{node.name}"] = hits

        visit(ast.parse(path.read_text()).body, "")
    return out


WALKED = _walk()


class Case(NamedTuple):
    fn: Callable
    kw: dict
    anchored: bool = False  # a method whose object holds tensors on a device


def _t(x):
    return torch.as_tensor(x)


@functools.lru_cache(maxsize=None)
def _scene(dtype):
    """343 particles on a jittered rest lattice (spacing 2r), their
    densities, weights, grid and the subdomain parameters (8-cell
    subdomains: 27 of them)."""
    rng = np.random.default_rng(11)
    coords = (np.arange(7) + 0.5) * 2 * R
    pts = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), -1).reshape(-1, 3)
    pts = (pts + rng.uniform(-0.2 * R, 0.2 * R, pts.shape) + 0.1234).astype(dtype)
    params = pt.Parameters.new_relative(
        R, 4.0, 1.5, grid_decomposition=pt.GridDecompositionParameters(8, auto_disable=False)
    ).try_convert(np.dtype(dtype).name)
    h, m = params.compact_support_radius, params.particle_rest_mass
    grid = grid_for_reconstruction(pts, R, h, params.cube_size)
    hsc = kernel_extents(h, grid.cell_size).half_supported_cells
    rho = tn.compute_particle_densities(_t(pts), h, m)
    values = tk.rounded(m, rho.dtype) / rho
    return dict(pts=pts, params=params, h=h, m=m, grid=grid, hsc=hsc, rho=rho, values=values,
                iso=params.iso_surface_threshold, rng=rng)


def _bins(s):
    grid = tn.BinGrid.for_domain(s["pts"].min(0), s["pts"].max(0), s["h"])
    cl = tn.build_cell_list(_t(s["pts"]), grid)
    return grid, cl, tn._round_up(tn.max_bin_occupancy(cl))


def _level_set(s):
    rasters, overflow = tgs.rasterize_global(_t(s["pts"]), s["values"], s["grid"], 2, s["hsc"])
    return tgs.sweep_global(rasters, overflow, s["grid"], s["h"], s["hsc"])


def _chunk(s):
    sd = ts.initialize_parameters(s["params"], s["grid"])
    tgt, pids, cells, ranks = ts.decompose(_t(s["pts"]), sd)
    ids, _, counts = ts.occupied_segments(tgt)
    ns = sd.num_subdomains
    sub_ijk = np.stack([ids // (ns[1] * ns[2]), (ids // ns[2]) % ns[1], ids % ns[2]], 1)
    rows = np.repeat(np.arange(len(ids)), counts)
    args = dict(positions=_t(s["pts"]), values=s["values"], pids=pids, rows=_t(rows),
                cells=cells, ranks=ranks, sub_ijk=_t(sub_ijk), sd=sd)
    return sd, args


def _cpu_mesh(n):
    pm.set_devices(["cpu"] * n)
    return pm.make_mesh(device="cpu")


def _interp(s):
    return pt.SphInterpolator(_t(s["pts"]), s["rho"], s["m"], s["h"])


def _queries(s, n=40):
    lo, hi = s["pts"].min(0), s["pts"].max(0)
    return _t(np.random.default_rng(5).uniform(lo, hi, (n, 3)).astype(s["pts"].dtype))


def _distances(s, n=300):
    return _t(np.random.default_rng(6).uniform(0, 1.2 * s["h"], n).astype(s["pts"].dtype))


def _ijk(s, n=200):
    hi = max(s["grid"].n_points) + 1
    return _t(np.random.default_rng(8).integers(-1, hi, (n, 3)))


def _sphere(dtype):
    mesh = icosphere(2, dtype)
    return _t(mesh.vertices * np.asarray([1.0, 0.8, 1.3], dtype)), _t(mesh.triangles)


CASES = {
    "aabb:Aabb3d.contains_points": lambda s: Case(
        pt.Aabb3d.from_points(s["pts"]).grow_uniformly(-0.02).contains_points,
        dict(points=_t(s["pts"]))),
    "aabb:aabb_from_points": lambda s: Case(pt.aabb.aabb_from_points, dict(points=_t(s["pts"]))),
    "density:rasterize_particles": lambda s: Case(pt.density.rasterize_particles, dict(
        positions=_t(s["pts"]), values=s["values"], grid=s["grid"], slots=2,
        overflow_capacity=64, ranks=_t(np.arange(len(s["pts"])) % 3))),
    "density:splat_level_set_scatter": lambda s: Case(pt.density.splat_level_set_scatter, dict(
        positions=_t(s["pts"]), values=s["values"], grid=s["grid"],
        compact_support_radius=s["h"], hsc=s["hsc"])),
    "global_pipeline:reconstruct_surface_global": lambda s: Case(
        pt.global_pipeline.reconstruct_surface_global,
        dict(positions=_t(s["pts"]), parameters=s["params"], grid=s["grid"])),
    "kernels:cubic_function": lambda s: Case(tk.cubic_function, dict(q=_distances(s) * 40)),
    "kernels:cubic_function_dq": lambda s: Case(tk.cubic_function_dq, dict(q=_distances(s) * 40)),
    "kernels:cubic_kernel": lambda s: Case(
        tk.cubic_kernel, dict(r=_distances(s), compact_support_radius=s["h"])),
    "kernels:cubic_kernel_rsq": lambda s: Case(
        tk.cubic_kernel_rsq, dict(r_sq=_distances(s) ** 2, compact_support_radius=s["h"])),
    "kernels:cubic_kernel_gradient": lambda s: Case(tk.cubic_kernel_gradient, dict(
        dx=_queries(s) - _t(s["pts"][:40]), compact_support_radius=s["h"])),
    "kernels:cubic_kernel_gradient_norm": lambda s: Case(
        tk.cubic_kernel_gradient_norm, dict(r=_distances(s), compact_support_radius=s["h"])),
    "kernels:DiscreteSquaredDistanceCubicKernel.evaluate": lambda s: Case(
        tk.DiscreteSquaredDistanceCubicKernel(1000, s["h"], s["pts"].dtype).evaluate,
        dict(r_sq=_distances(s) ** 2)),
    "mc.dense:marching_cubes_padded": lambda s: Case(tmc.marching_cubes_padded, dict(
        values=_level_set(s), iso=s["iso"], grid_min=s["grid"].min,
        cell_size=s["grid"].cell_size, vertex_capacity=20000, triangle_capacity=40000)),
    "mc.dense:decode_edge_flat": lambda s: Case(tmc.decode_edge_flat, dict(
        edge_flat=_t(np.random.default_rng(9).integers(-1, 3 * s["grid"].total_points, 200)),
        n_points=s["grid"].n_points)),
    "mc.dense:marching_cubes": lambda s: Case(tmc.marching_cubes, dict(
        values=_level_set(s), iso=s["iso"], cube_size=s["grid"].cell_size,
        translation=s["grid"].min)),
    "mesh:face_normals": lambda s: Case(pt.mesh.face_normals, dict(
        zip(("vertices", "triangles"), _sphere(s["pts"].dtype)))),
    "mesh:vertex_normals": lambda s: Case(pt.mesh.vertex_normals, dict(
        zip(("vertices", "triangles"), _sphere(s["pts"].dtype)))),
    "neighbors:BinGrid.bin_ijk": lambda s: Case(_bins(s)[0].bin_ijk, dict(positions=_t(s["pts"]))),
    "neighbors:build_cell_list": lambda s: Case(
        tn.build_cell_list, dict(positions=_t(s["pts"]), grid=_bins(s)[0])),
    "neighbors:gather_candidates": lambda s: (lambda g, cl, cap: Case(tn.gather_candidates, dict(
        query_positions=_queries(s), grid=g, cell_list=cl, capacity=cap,
        tables=tn._segment_tables(cl.sorted_bins, g.lattice))))(*_bins(s)),
    "neighbors:neighbor_counts_and_distsq": lambda s: (lambda g, cl, cap: Case(
        tn.neighbor_counts_and_distsq, dict(positions=_t(s["pts"]), grid=g, cell_list=cl,
                                            radius=s["h"], capacity=cap)))(*_bins(s)),
    "neighbors:neighbor_lists_padded": lambda s: (lambda g, cl, cap: Case(
        tn.neighbor_lists_padded, dict(positions=_t(s["pts"]), grid=g, cell_list=cl,
                                       radius=s["h"], capacity=cap, max_neighbors=64)))(*_bins(s)),
    "neighbors:neighborhood_search_spatial_hashing_parallel": lambda s: Case(
        tn.neighborhood_search_spatial_hashing_parallel,
        dict(positions=_t(s["pts"]), radius=s["h"])),
    "neighbors:compute_particle_densities_binned": lambda s: (lambda g, cl, cap: Case(
        tn.compute_particle_densities_binned, dict(
            positions=_t(s["pts"]), grid=g, cell_list=cl, compact_support_radius=s["h"],
            particle_rest_mass=s["m"], capacity=cap, u_cap=1 << 12)))(*_bins(s)),
    "neighbors:compute_particle_densities_raster": lambda s: (lambda g, cl, cap: Case(
        tn.compute_particle_densities_raster, dict(
            positions=_t(s["pts"]), grid=g, cell_list=cl, compact_support_radius=s["h"],
            particle_rest_mass=s["m"], slots=2, overflow_capacity=256,
            candidate_capacity=cap)))(*_bins(s)),
    "neighbors:compute_particle_densities_geoslot": lambda s: Case(
        tn.compute_particle_densities_geoslot, dict(
            positions=_t(s["pts"]), grid=_bins(s)[0], compact_support_radius=s["h"],
            particle_rest_mass=s["m"])),
    "neighbors:compute_particle_densities": lambda s: Case(tn.compute_particle_densities, dict(
        positions=_t(s["pts"]), compact_support_radius=s["h"], particle_rest_mass=s["m"])),
    "ops.global_sweep:rasterize_global": lambda s: Case(tgs.rasterize_global, dict(
        positions=_t(s["pts"]), values=s["values"], grid=s["grid"], slots=2, hsc=s["hsc"],
        slab_x0=0)),
    "ops.global_sweep:sweep_global": lambda s: (lambda r, o: Case(tgs.sweep_global, dict(
        rasters=r, overflow=o, grid=s["grid"], compact_support_radius=s["h"],
        hsc=s["hsc"])))(*tgs.rasterize_global(_t(s["pts"]), s["values"], s["grid"], 1, s["hsc"])),
    "ops.global_sweep:density_weights_from_rasters": lambda s: (lambda fr, meta: Case(
        tgs.density_weights_from_rasters, dict(
            zip(("fx", "fy", "fz", "rank", "ok", "cx", "cy", "cz"), (*fr, *meta)),
            particle_rest_mass=s["m"], compact_support_radius=s["h"], grid=s["grid"],
            hsc=s["hsc"], reach=int(np.ceil(s["h"] / s["grid"].cell_size - 1e-9)),
            h_over_cs=s["h"] / s["grid"].cell_size)))(
        *tgs.rasterize_global(_t(s["pts"]), None, s["grid"], 2, s["hsc"], with_meta=True)[::2]),
    "ops.global_sweep:mc_global_packed": lambda s: Case(
        tgs.mc_global_packed, dict(ls=_level_set(s), grid=s["grid"], iso=s["iso"])),
    "ops.global_sweep:mc_global_cells": lambda s: Case(tgs.mc_global_cells, dict(
        ls=_level_set(s), grid=s["grid"], iso=s["iso"], own_px=s["grid"].n_points[0] - 4)),
    "ops.global_sweep:reconstruct_global_dense": lambda s: Case(tgs.reconstruct_global_dense, dict(
        positions=_t(s["pts"]), values=s["values"], grid=s["grid"],
        compact_support_radius=s["h"], hsc=s["hsc"], iso=s["iso"])),
    "ops.slab_sweep:reconstruct_global_slabbed": lambda s: Case(
        tslab.reconstruct_global_slabbed, dict(
            positions=_t(s["pts"]), values=s["values"], grid=s["grid"],
            compact_support_radius=s["h"], hsc=s["hsc"], iso=s["iso"], max_cells=3000)),
    "ops.slab_sweep:reconstruct_surface_slabbed": lambda s: Case(
        tslab.reconstruct_surface_slabbed,
        dict(positions=_t(s["pts"]), parameters=s["params"], grid=s["grid"])),
    "parallel.decompose:decompose_sharded": lambda s: Case(
        pt.parallel.decompose.decompose_sharded, dict(
            positions=_t(s["pts"]), sd=ts.initialize_parameters(s["params"], s["grid"]),
            mesh=_cpu_mesh(2))),
    "parallel.density:compute_particle_densities_sharded": lambda s: Case(
        pt.parallel.density.compute_particle_densities_sharded, dict(
            positions=_t(s["pts"]), compact_support_radius=s["h"],
            particle_rest_mass=s["m"], mesh=_cpu_mesh(2))),
    "postprocess:laplacian_smoothing": lambda s: (lambda v, t: Case(
        pt.postprocess.laplacian_smoothing, dict(
            vertices=v, triangles=t, iterations=3, beta=0.5,
            weights=_t(np.linspace(0.3, 1.0, len(v)).astype(s["pts"].dtype)))))(
        *_sphere(s["pts"].dtype)),
    "postprocess:laplacian_smoothing_normals": lambda s: (lambda v, t: Case(
        pt.postprocess.laplacian_smoothing_normals,
        dict(normals=v, triangles=t, num_vertices=len(v), iterations=3)))(
        *_sphere(s["pts"].dtype)),
    "sph_interpolation:SphInterpolator.__init__": lambda s: Case(pt.SphInterpolator, dict(
        particle_positions=_t(s["pts"]), particle_densities=s["rho"],
        particle_rest_mass=s["m"], compact_support_radius=s["h"])),
    "sph_interpolation:SphInterpolator.interpolate_normals": lambda s: Case(
        _interp(s).interpolate_normals, dict(points=_queries(s)), anchored=True),
    "sph_interpolation:SphInterpolator.interpolate_scalar_quantity": lambda s: Case(
        _interp(s).interpolate_scalar_quantity,
        dict(particle_quantity=s["rho"], points=_queries(s)), anchored=True),
    "sph_interpolation:SphInterpolator.interpolate_vector_quantity": lambda s: Case(
        _interp(s).interpolate_vector_quantity,
        dict(particle_quantity=_t(s["pts"]) * 2, points=_queries(s)), anchored=True),
    "sph_interpolation:compute_weighted_neighbor_counts": lambda s: Case(
        pt.sph_interpolation.compute_weighted_neighbor_counts,
        dict(positions=_t(s["pts"]), compact_support_radius=s["h"])),
    "subdomains:decompose": lambda s: Case(ts.decompose, dict(
        positions=_t(s["pts"]), sd=ts.initialize_parameters(s["params"], s["grid"]))),
    "subdomains:chunk_levelset_scatter": lambda s: (lambda sd, a: Case(
        ts.chunk_levelset_scatter, dict(
            {k: a[k] for k in ("positions", "values", "pids", "rows", "sub_ijk")},
            sd=sd, compact_support_radius=s["h"], hsc=sd.margin_cells)))(*_chunk(s)),
    "subdomains:chunk_levelset_raster": lambda s: (lambda sd, a: Case(
        ts.chunk_levelset_raster, dict(a, compact_support_radius=s["h"], hsc=sd.margin_cells)))(
        *_chunk(s)),
    "subdomains:chunk_mc": lambda s: (lambda sd, a: Case(ts.chunk_mc, dict(
        ls=ts.chunk_levelset_raster(**a, compact_support_radius=s["h"], hsc=sd.margin_cells),
        sub_ijk=a["sub_ijk"], sd=sd, iso=s["iso"])))(*_chunk(s)),
    "subdomains:chunk_mc_encode": lambda s: (lambda sd, a: Case(ts.chunk_mc_encode, dict(
        ls=ts.chunk_levelset_raster(**a, compact_support_radius=s["h"], hsc=sd.margin_cells),
        sd=sd, iso=s["iso"])))(*_chunk(s)),
    "subdomains:reconstruct_surface_subdomain_grid": lambda s: Case(
        ts.reconstruct_surface_subdomain_grid,
        dict(positions=_t(s["pts"]), parameters=s["params"], grid=s["grid"])),
    "uniform_grid:UniformGrid.point_coordinates": lambda s: Case(
        s["grid"].point_coordinates, dict(ijk=_ijk(s), dtype=torch.float64)),
    "uniform_grid:UniformGrid.enclosing_cell": lambda s: Case(
        s["grid"].enclosing_cell, dict(x=_queries(s))),
    "uniform_grid:UniformGrid.flatten_point_index": lambda s: Case(
        s["grid"].flatten_point_index, dict(ijk=_ijk(s).to(torch.int32))),
    "uniform_grid:UniformGrid.flatten_cell_index": lambda s: Case(
        s["grid"].flatten_cell_index, dict(ijk=_ijk(s))),
    "uniform_grid:UniformGrid.unflatten_point_index": lambda s: Case(
        s["grid"].unflatten_point_index, dict(flat=_ijk(s)[:, 0] * 97)),
    "uniform_grid:UniformGrid.unflatten_cell_index": lambda s: Case(
        s["grid"].unflatten_cell_index, dict(flat=_ijk(s)[:, 0].to(torch.int32) * 89)),
    **{
        f"uniform_grid:UniformGrid.{name}": (
            lambda name: lambda s: Case(getattr(s["grid"], name), dict(ijk=_ijk(s))))(name)
        for name in ("point_in_grid", "cell_in_grid", "is_boundary_point", "is_boundary_cell")
    },
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_devices():
    """Every test leaves the process's default device list behind."""
    yield
    pm.set_devices(None)


def _as_arrays(v, walked: bool):
    """A call's argument with every tensor in it (at the top, or in a plain
    tuple or list) a numpy array; a walked scalar, or tuple of scalars, as
    a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    is_number = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
    if walked and (is_number(v) or (type(v) is tuple and all(map(is_number, v)))):
        return np.asarray(v)
    if type(v) in (tuple, list):
        return type(v)(_as_arrays(x, False) for x in v)
    return v


def _holds_tensor(v) -> bool:
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, (tuple, list)):
        return any(map(_holds_tensor, v))
    if isinstance(v, dict):
        return any(map(_holds_tensor, v.values()))
    return False


def _same(a, b, where="result"):
    """Equal bit for bit, dtypes included; a tensor and a numpy array
    compare by value (an array-like call may return numpy where the tensor
    call returns a CPU tensor, as ``mesh.face_normals`` does)."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or isinstance(b, (torch.Tensor, np.ndarray)):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            assert a.device == b.device, where
        an = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        bn = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert an.dtype == bn.dtype and an.shape == bn.shape, (where, an.dtype, bn.dtype)
        np.testing.assert_array_equal(an, bn, err_msg=where)
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, pt.SphInterpolator):
        assert type(b) is pt.SphInterpolator, where
        _same({k: v for k, v in vars(a).items() if not k.startswith("_")},
              {k: v for k, v in vars(b).items() if not k.startswith("_")}, where)
    else:
        assert a == b, (where, a, b)


def _call(key, dtype):
    """(the tensor call's result, the array call's result) of a case."""
    case = CASES[key](_scene(dtype))
    walked = WALKED[key]
    arrays = {k: _as_arrays(v, k in walked) for k, v in case.kw.items()}
    clear_port_plans()
    want = case.fn(**case.kw, device="cpu")
    clear_port_plans()
    tn.reset_geoslot_hysteresis()
    got = case.fn(**arrays, device="cpu")
    return want, got


def test_the_walk_finds_the_functions_the_port_must_take_arrays_in():
    assert len(WALKED) >= 59
    for key in ("neighbors:compute_particle_densities", "kernels:cubic_kernel",
                "aabb:aabb_from_points", "aabb:Aabb3d.contains_points",
                "uniform_grid:UniformGrid.enclosing_cell"):
        assert key in WALKED, key
    assert not any(k.startswith(SKIPPED_MODULES) for k in WALKED)
    assert set(CASES) | set(ARRAY_INPUT_NOT_PORTED) == set(WALKED)
    assert not set(CASES) & set(ARRAY_INPUT_NOT_PORTED)


def _port_callable(key):
    mod, _, qual = key.partition(":")
    obj = importlib.import_module(f"splashsurf_tpu_torch.{mod}")
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def test_array_input_not_ported_entries_are_real():
    """The table cannot go stale: each entry is a walked function whose
    port counterpart has no ``device=``."""
    for key, why in ARRAY_INPUT_NOT_PORTED.items():
        assert why and key in WALKED, key
        assert "device" not in inspect.signature(_port_callable(key)).parameters, key


@pytest.mark.parametrize("key", sorted(CASES))
def test_every_walked_function_takes_device_last(key):
    params = list(inspect.signature(_port_callable(key)).parameters.values())
    assert params[-1].name == "device" and params[-1].default is None, key


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("key", sorted(CASES))
def test_array_call_equals_the_tensor_call(key, dtype):
    want, got = _call(key, DTYPES[dtype])
    _same(want, got)


@pytest.mark.parametrize("key", sorted(CASES))
def test_array_call_without_device_raises_without_cuda(key, monkeypatch):
    case = CASES[key](_scene(np.float32))
    arrays = {k: _as_arrays(v, k in WALKED[key]) for k, v in case.kw.items()}
    if case.anchored or _holds_tensor(arrays):
        # a tensor among the inputs (the object's own, a cell list) decides
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case.fn(**arrays)


def test_on_device_passes_tensors_through():
    x = torch.arange(6.0).reshape(2, 3)
    y = torch.ones(3, dtype=torch.int32)
    assert placement.on_device(x) is x
    assert placement.on_device(x, device="cpu") is x
    a, b, c = placement.on_device(x, y, None)
    assert a is x and b is y and c is None
    with pytest.raises(ValueError):
        placement.on_device(x, device="meta")
    # an array follows the first tensor among the inputs; numpy keeps its dtype
    arr, t = placement.on_device(np.zeros(3, np.float32), x)
    assert t is x and arr.dtype == torch.float32 and arr.device == x.device
    assert placement.on_device([1, 2], device="cpu").dtype == torch.int64
    assert placement.on_device(0.5, device="cpu").dtype == torch.float64


def test_on_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        placement.on_device(np.zeros(3))
    assert placement.on_device(None) is None


# --- the members of the value types against the reference --------------------


def test_aabb_members_equal_the_reference():
    rng = np.random.default_rng(21)
    for _ in range(5):
        lo = rng.uniform(-2, 1, 3)
        a_min, a_max = lo, lo + rng.uniform(0.1, 3, 3)
        b_min = rng.uniform(-2, 1, 3)
        b_max = b_min + rng.uniform(0.1, 3, 3)
        ja, jb = st.Aabb3d.from_min_max(a_min, a_max), st.Aabb3d.from_min_max(b_min, b_max)
        ta, tb = pt.Aabb3d.from_min_max(a_min, a_max), pt.Aabb3d.from_min_max(b_min, b_max)
        assert (ta.min, ta.max) == (ja.min, ja.max)
        for got, want in ((ta.extents(), ja.extents()), (ta.centroid(), ja.centroid())):
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)
        j = ta.join(tb)
        assert isinstance(j, pt.Aabb3d) and (j.min, j.max) == (ja.join(jb).min, ja.join(jb).max)
        jall = pt.Aabb3d.join_all([ta, tb, j])
        want = st.Aabb3d.join_all([ja, jb, ja.join(jb)])
        assert (jall.min, jall.max) == (want.min, want.max)
        pts = rng.uniform(-3, 5, (200, 3))
        pts[:3] = (a_min, a_max, 0.5 * (a_min + a_max))  # the corners: inclusive
        for p in pts:
            got = ta.contains_point(p)
            assert type(got) is bool and got == ja.contains_point(p)
        np.testing.assert_array_equal(
            ta.contains_points(pts, device="cpu").numpy(), np.asarray(ja.contains_points(pts)))
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    got, want = pt.Aabb3d.par_from_points(pts), st.Aabb3d.par_from_points(pts)
    assert (got.min, got.max) == (want.min, want.max)


@pytest.fixture(params=[((0.0, 0.0, 0.0), 0.5, (4, 4, 4)), ((0.13, -0.4, 2.05), 0.037, (5, 7, 9))],
                ids=["unit", "skewed"])
def grids(request):
    mn, cs, nc = request.param
    return st.UniformGrid(min=mn, cell_size=cs, n_cells=nc), pt.UniformGrid(
        min=mn, cell_size=cs, n_cells=nc)


def test_grid_sizes_and_aabb_equal_the_reference(grids):
    jg, tg = grids
    assert tg.ncells_per_dim() == jg.ncells_per_dim() and type(tg.ncells_per_dim()) is list
    assert tg.npoints_per_dim() == jg.npoints_per_dim() and type(tg.npoints_per_dim()) is list
    assert tg.total_points == jg.total_points
    box = tg.aabb()
    assert isinstance(box, pt.Aabb3d) and (box.min, box.max) == (jg.aabb().min, jg.aabb().max)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_point_coordinates_equal_the_reference(grids, dtype):
    jg, tg = grids
    ijk = np.random.default_rng(22).integers(-2, 12, (500, 3))
    want = np.asarray(jg.point_coordinates(ijk, dtype))
    for dt in (dtype, getattr(torch, np.dtype(dtype).name)):
        got = tg.point_coordinates(ijk, dt, device="cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tg.point_coordinates(ijk, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("itype", [np.int32, np.int64])
def test_flatten_round_trips_equal_the_reference(grids, itype):
    jg, tg = grids
    for dims, flat, unflat, jflat, junflat in (
        (tg.n_points, tg.flatten_point_index, tg.unflatten_point_index,
         jg.flatten_point_index, jg.unflatten_point_index),
        (tg.n_cells, tg.flatten_cell_index, tg.unflatten_cell_index,
         jg.flatten_cell_index, jg.unflatten_cell_index),
    ):
        ijk = np.stack(np.meshgrid(*map(np.arange, dims), indexing="ij"), -1).reshape(-1, 3)
        ijk = ijk.astype(itype)
        f = flat(ijk, device="cpu")
        assert f.dtype == getattr(torch, np.dtype(itype).name)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jflat(ijk)))
        np.testing.assert_array_equal(f.numpy(), np.arange(len(ijk)))
        back = unflat(f.numpy(), device="cpu")
        np.testing.assert_array_equal(back.numpy(), np.asarray(junflat(np.asarray(f))))
        np.testing.assert_array_equal(back.numpy(), ijk)


def test_grid_predicates_equal_the_reference(grids):
    jg, tg = grids
    ijk = np.random.default_rng(23).integers(-1, 11, (500, 3))
    ijk[:4] = [(0, 1, 1), (1, 1, 1), (4, 4, 4), (5, 0, 0)]
    for name in ("point_in_grid", "cell_in_grid", "is_boundary_point", "is_boundary_cell"):
        got = getattr(tg, name)(ijk, device="cpu")
        want = np.asarray(getattr(jg, name)(ijk))
        assert got.dtype == torch.bool and got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        one = getattr(tg, name)(ijk[0], device="cpu")
        assert one.shape == () and bool(one) == bool(getattr(jg, name)(ijk[0])), name


def test_enclosing_cell_values_equal_the_reference(grids):
    """Equal values; int64 where the reference gives int32 (see ROADMAP's
    "Not port faults")."""
    jg, tg = grids
    x = np.random.default_rng(24).uniform(-1, 3, (500, 3)).astype(np.float32)
    got = tg.enclosing_cell(x, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.enclosing_cell(x)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_parameters_np_dtype_equals_the_reference(dtype):
    jp = st.Parameters.new_relative(0.025, 4.0, 1.5).try_convert(dtype)
    tp = pt.Parameters.new_relative(0.025, 4.0, 1.5).try_convert(dtype)
    assert tp.np_dtype == jp.np_dtype == np.dtype(dtype)
    assert tp.torch_dtype == getattr(torch, dtype)
