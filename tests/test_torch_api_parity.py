"""The port's pysplashsurf-parity surface: every name of the JAX package's
``__all__`` and every submodule it loads on access resolves on
``splashsurf_tpu_torch`` to the port's counterpart, ``parallel`` with the
reference's ``__all__``; every public name that a module of the JAX
package defines itself resolves on the port's counterpart module, but for
the written ``NOT_PORTED`` table, whose entries are held absent; every
public member of the classes it defines is on the port's class, with the
reference's parameters and defaults, but for ``MEMBERS_NOT_PORTED``; every
``SPLASHSURF_TPU_*`` switch that the JAX package reads, the port reads, but
for the written ``NOT_READ`` table, with the reference's literal default, but
for ``DEFAULTS_DIFFER``; the debug outputs
(``density_map_to_hex_mesh``) and the meshio BGEO plugin give the JAX
package's results; and the thin pysplashsurf methods behave as the JAX
package's parity tests hold them, on the CPU."""

import ast
import importlib
import inspect
import pathlib
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import splashsurf_tpu as st
from splashsurf_tpu import meshio_bgeo as jbgeo
from splashsurf_tpu.mesh import density_map_to_hex_mesh as ref_hex

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import meshio_bgeo as tbgeo
from splashsurf_tpu_torch.io import bgeo as tbgeo_io
from splashsurf_tpu_torch.mesh import HexMesh3d, PointCloud3d, density_map_to_hex_mesh
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

# the submodules the JAX package's ``__getattr__`` loads on access
REFERENCE_SUBMODULES = (
    "io", "mesh", "profiling", "postprocess", "pipeline", "mc", "neighbors", "density",
    "subdomains", "sph_interpolation", "sequence", "parallel", "cli", "studio",
)
_SHARD_MAP = (
    "a jit(shard_map) factory: the port's per-shard step in parallel/mesh.py "
    "(_levelset_mc_step, sharded_halo_overwrite) does this work over a device list"
)
# Public names of the JAX package that the port leaves out on purpose, by
# module path relative to the package (a whole module where the path names
# one), each with its reason. Nothing else may be missing.
NOT_PORTED = {
    "parallel.mesh.sharded_mc_counts_encoded": _SHARD_MAP,
    "parallel.mesh.sharded_scan_mc_encode": _SHARD_MAP,
    "parallel.mesh.sharded_splat_scatter": _SHARD_MAP,
    "parallel.mesh.sharded_splat_raster": _SHARD_MAP,
    "parallel.mesh.sharded_scan_splat": _SHARD_MAP,
    "parallel.mesh.sharded_scan_splat_pairs": _SHARD_MAP,
    "parallel.mesh.sharded_mc_counts": _SHARD_MAP,
    "parallel.mesh.sharded_scan_mc": _SHARD_MAP,
    "parallel.mesh.sharded_chunk_mc": _SHARD_MAP,
    "ops.prefix": "the MXU blocked prefix sum; the port uses torch.cumsum",
    "ops.splat_pallas": "the Pallas kernels; the port's are ops/splat_kernels.py with csrc/",
    "workspace": "the JAX persistent compile cache; the port compiles no programs",
}
_BACKEND = "the TPU's choice of a Pallas kernel or an XLA scan; the port has one route per device"
_ROWS = (
    "the port takes n_valid at its entry points (compute_particle_densities, "
    "reconstruct_surface_global, the slab and subdomain routes) and keeps those rows, "
    "so its cell lists and rasters hold particles only"
)
_CHUNK_ROWS = (
    "the port's chunk takes the positions and values with the chunk's pair rows "
    "(pids, rows, cells, ranks) in place of the reference's extended arrays and "
    "padded per-subdomain lists"
)
_EXACT = "the port sizes this list exactly (its count read back), where the reference plans a capacity"
# Parameters of reference functions and classes that the port's counterpart
# leaves out on purpose ("module.name:parameter"), each with its reason.
# Every other parameter of the reference is present on the port, with the
# reference's default where it has one.
SIGNATURE_NOT_PORTED = {
    "neighbors.build_cell_list:n_valid": _ROWS,
    "neighbors.build_cell_list:has_n_valid": _ROWS,
    "neighbors.compute_particle_densities_geoslot:n_valid": _ROWS,
    "neighbors.compute_particle_densities_geoslot:has_n_valid": _ROWS,
    "neighbors.compute_particle_densities_geoslot:backend": _BACKEND,
    "neighbors.compute_particle_densities_raster:backend": _BACKEND,
    "ops.global_sweep.density_weights_from_rasters:backend": _BACKEND,
    "ops.global_sweep.reconstruct_global_dense:backend": _BACKEND,
    "ops.global_sweep.sweep_global:backend": _BACKEND,
    "ops.global_sweep.rasterize_global:lane_align": (
        "the TPU sweep's (8, 128) tile alignment of the raster's minor dims"
    ),
    **{
        f"ops.global_sweep.sweep_global:{a}": (
            "the port passes the four rasters and the four overflow columns as two "
            "tuples, (rasters, overflow)"
        )
        for a in ("fx", "fy", "fz", "fv", "opx", "opy", "opz", "oval")
    },
    **{f"subdomains.chunk_levelset_raster:{a}": _CHUNK_ROWS
       for a in ("positions_ext", "values_ext", "plists", "plocal", "prank")},
    **{f"subdomains.chunk_levelset_scatter:{a}": _CHUNK_ROWS
       for a in ("positions_ext", "values_ext", "plists")},
    "subdomains.chunk_levelset_raster:slots": "the port's subdomain rasters have SLOTS = 2",
    "subdomains.chunk_levelset_raster:unroll": _BACKEND,
    "subdomains.chunk_mc:pack_vertex_capacity": _EXACT,
    "subdomains.chunk_mc:pack_triangle_capacity": _EXACT,
    "subdomains.decompose:pair_capacity": _EXACT,
    "subdomains.reconstruct_surface_subdomain_grid:chunk_size": (
        "the port sizes splat chunks by a byte budget (chunk_bytes), not by a "
        "subdomain count"
    ),
    "subdomains.reconstruct_surface_subdomain_grid:raster_threshold": (
        "the port always rasterizes (kernel K3) and splats only the slot overflow; "
        "the reference's threshold picks the scatter splat off the TPU"
    ),
}


def _is_source_module(info) -> bool:
    """A package or a ``.py`` file: not an extension module or a built
    shared library, which exist only once a run before has built them."""
    if info.ispkg:
        return True
    leaf = info.name.rpartition(".")[2]
    return (pathlib.Path(info.module_finder.path) / f"{leaf}.py").is_file()


# the JAX package's source modules: the same list whether or not its
# native library has been built
REFERENCE_MODULES = ["splashsurf_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(st.__path__, "splashsurf_tpu.")
    if not m.name.endswith("__main__") and _is_source_module(m)
)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", st.__all__)
def test_reference_name_resolves_on_the_port(name):
    ref = getattr(st, name)
    got = getattr(pt, name)
    if isinstance(ref, types.ModuleType):
        assert got.__name__ == ref.__name__.replace("splashsurf_tpu", "splashsurf_tpu_torch", 1)
        return
    assert got.__module__.split(".")[0] == "splashsurf_tpu_torch", (name, got.__module__)
    assert got.__module__.split(".")[1:] == ref.__module__.split(".")[1:], name
    assert got.__qualname__ == ref.__qualname__, name
    assert name in pt.__all__


def _rel(module_name: str) -> str:
    return module_name.partition(".")[2]


def _port_module(rel: str):
    """The port's counterpart of the reference module at ``rel``, or None."""
    name = "splashsurf_tpu_torch" + (f".{rel}" if rel else "")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        return None


def _defined_names(mod) -> set:
    """The public names that ``mod`` defines itself: callables and classes
    whose ``__module__`` is ``mod``, and names assigned at its top level
    that hold neither a module nor a callable (constants)."""
    names = {
        k for k, v in vars(mod).items()
        if not k.startswith("_") and not isinstance(v, types.ModuleType)
        and callable(v) and getattr(v, "__module__", None) == mod.__name__
    }
    tree = ast.parse(inspect.getsource(mod))
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and not n.id.startswith("_") and n.id in vars(mod):
                    v = vars(mod)[n.id]
                    if not isinstance(v, types.ModuleType) and not callable(v):
                        names.add(n.id)
    return names


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_every_reference_module_name_resolves_on_the_port(module):
    rel = _rel(module)
    if rel in NOT_PORTED:
        assert _port_module(rel) is None, rel
        return
    ref = importlib.import_module(module)
    port = _port_module(rel)
    assert port is not None, f"splashsurf_tpu_torch.{rel} is missing"
    missing = []
    for name in sorted(_defined_names(ref)):
        key = f"{rel}.{name}" if rel else name
        if key in NOT_PORTED:
            continue
        if not hasattr(port, name):
            missing.append(name)
    assert not missing, (module, missing)


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_not_ported_entries_exist_in_the_reference_and_not_in_the_port(entry):
    """The table cannot go stale: each entry names a module or a name of the
    JAX package that the port really lacks."""
    assert NOT_PORTED[entry]
    if f"splashsurf_tpu.{entry}" in REFERENCE_MODULES:
        assert _port_module(entry) is None, entry
        return
    rel, _, name = entry.rpartition(".")
    ref = importlib.import_module(f"splashsurf_tpu.{rel}")
    assert name in _defined_names(ref), entry
    port = _port_module(rel)
    assert port is not None and not hasattr(port, name), entry


def _parameters(obj):
    """The parameters of a callable's signature, or None where it has none
    that ``inspect`` can read (a builtin exception type)."""
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None


def _same_default(ref, port) -> bool:
    """Equal defaults; an enum member or a dataclass of the reference equals
    the port's copy of it when their values do, and a numpy or ``jnp`` dtype
    the torch dtype of the same name (dtypes only: no string or None)."""
    if ref is port:
        return True
    if isinstance(port, torch.dtype) and ref is not None and not isinstance(ref, str):
        try:
            return np.dtype(ref).name == str(port).removeprefix("torch.")
        except TypeError:
            return False
    if type(ref).__name__ != type(port).__name__:
        return False
    if hasattr(ref, "value") and hasattr(port, "value"):
        return ref.value == port.value
    try:
        return bool(ref == port) or repr(ref) == repr(port)
    except Exception:
        return False


def _signature_gaps(module: str) -> list:
    """The reference module's public functions and classes whose parameters
    the port's counterpart lacks, or whose defaults differ, less the
    ``SIGNATURE_NOT_PORTED`` table: ["name:parameter (why)", ...]."""
    rel = _rel(module)
    ref, port = importlib.import_module(module), _port_module(rel)
    gaps = []
    for name in sorted(_defined_names(ref)):
        key = f"{rel}.{name}" if rel else name
        if key in NOT_PORTED or not hasattr(port, name):
            continue
        theirs, ours = _parameters(getattr(ref, name)), _parameters(getattr(port, name))
        if theirs is None or ours is None:
            continue
        for pname, par in theirs.items():
            if par.kind in (par.VAR_POSITIONAL, par.VAR_KEYWORD):
                continue
            if f"{key}:{pname}" in SIGNATURE_NOT_PORTED:
                continue
            if pname not in ours:
                gaps.append(f"{key}:{pname} (missing)")
            elif par.default is not par.empty and not _same_default(
                par.default, ours[pname].default
            ):
                gaps.append(f"{key}:{pname} (default {par.default!r} != {ours[pname].default!r})")
    return gaps


@pytest.mark.parametrize(
    "module", [m for m in REFERENCE_MODULES if _rel(m) not in NOT_PORTED]
)
def test_every_reference_signature_holds_on_the_port(module):
    """Every parameter of the reference's public functions and classes is a
    parameter of the port's counterpart, with the reference's default where
    it has one, but for ``SIGNATURE_NOT_PORTED``."""
    assert not _signature_gaps(module), module


@pytest.mark.parametrize("entry", sorted(SIGNATURE_NOT_PORTED))
def test_signature_not_ported_entries_are_real(entry):
    """The table cannot go stale: each entry names a parameter of the
    reference that the port's counterpart really lacks."""
    assert SIGNATURE_NOT_PORTED[entry]
    path, _, pname = entry.partition(":")
    rel, _, name = path.rpartition(".")
    ref = getattr(importlib.import_module(f"splashsurf_tpu.{rel}"), name)
    port = getattr(_port_module(rel), name)
    assert pname in _parameters(ref), entry
    assert pname not in _parameters(port), entry


# Public members of the reference's classes that the port's counterpart
# leaves out on purpose ("module.Class.member"), each with its reason.
MEMBERS_NOT_PORTED: dict = {}


def _class_pairs(module: str):
    """(key, reference class, port class) of every public class that the
    reference module defines and the port's counterpart resolves."""
    rel = _rel(module)
    ref, port = importlib.import_module(module), _port_module(rel)
    for name in sorted(_defined_names(ref)):
        key = f"{rel}.{name}" if rel else name
        cls = getattr(ref, name)
        if isinstance(cls, type) and key not in NOT_PORTED and hasattr(port, name):
            yield key, cls, getattr(port, name)


def _member_gaps(module: str) -> list:
    """The public members (``dir()``, inherited ones included) of the
    reference module's classes that the port's classes lack, less
    ``MEMBERS_NOT_PORTED``; a property where the port has a method or the
    reverse; and the parameters of shared methods that the port lacks, or
    whose defaults differ (``_same_default``)."""
    gaps = []
    for key, theirs, ours in _class_pairs(module):
        for member in dir(theirs):
            path = f"{key}.{member}"
            if member.startswith("_") or path in MEMBERS_NOT_PORTED:
                continue
            if not hasattr(ours, member):
                gaps.append(f"{path} (missing)")
                continue
            kinds = [isinstance(inspect.getattr_static(c, member), property) for c in (theirs, ours)]
            if kinds[0] != kinds[1]:
                gaps.append(f"{path} (property on one side only)")
                continue
            ref_params = None if kinds[0] else _parameters(getattr(theirs, member))
            port_params = _parameters(getattr(ours, member))
            for pname, par in (ref_params or {}).items():
                if par.kind in (par.VAR_POSITIONAL, par.VAR_KEYWORD):
                    continue
                if port_params is None or pname not in port_params:
                    gaps.append(f"{path}:{pname} (missing)")
                elif par.default is not par.empty and not _same_default(
                    par.default, port_params[pname].default
                ):
                    gaps.append(f"{path}:{pname} (default {par.default!r} != "
                                f"{port_params[pname].default!r})")
    return gaps


@pytest.mark.parametrize(
    "module", [m for m in REFERENCE_MODULES if _rel(m) not in NOT_PORTED]
)
def test_every_reference_class_member_holds_on_the_port(module):
    """Every public member of the reference's classes is on the port's
    class, a property where it is one, with the reference's parameters and
    defaults, but for ``MEMBERS_NOT_PORTED``."""
    assert not _member_gaps(module), module


def test_members_not_ported_entries_are_real():
    """The table cannot go stale: each entry names a public member of a
    reference class that the port's class really lacks."""
    for entry, why in MEMBERS_NOT_PORTED.items():
        assert why, entry
        path, _, member = entry.rpartition(".")
        rel, _, name = path.rpartition(".")
        assert member in dir(getattr(importlib.import_module(f"splashsurf_tpu.{rel}"), name))
        assert not hasattr(getattr(_port_module(rel), name), member), entry


def test_the_member_walk_sees_the_value_types():
    """A spot check: the walk reaches the pysplashsurf-parity value types
    and the dtype default of ``UniformGrid.point_coordinates``."""
    keys = {k for m in REFERENCE_MODULES if _rel(m) not in NOT_PORTED for k, _, _ in _class_pairs(m)}
    assert {"aabb.Aabb3d", "uniform_grid.UniformGrid", "params.Parameters"} <= keys
    import jax.numpy as jnp

    assert _same_default(jnp.float32, torch.float32) and _same_default(np.float64, torch.float64)
    assert not _same_default(jnp.float32, torch.float64)
    assert not _same_default("float32", torch.float32) and not _same_default(None, torch.float32)


# The environment switches: the reference's that the port does not read,
# each with its reason. None changes a route, a formulation or a mesh
# beyond rounding.
_TPU_MECHANISM = "a TPU mechanism that the port leaves out"
NOT_READ = {
    "SPLASHSURF_TPU_CACHE": f"{_TPU_MECHANISM}: JAX's persistent compile cache (workspace); "
                            "the port compiles no programs",
    "SPLASHSURF_TPU_PACK_SCATTER": f"{_TPU_MECHANISM}: two f32 components packed into one "
                                   "complex scatter, as the TPU's scatters cost per row",
    "SPLASHSURF_TPU_MXU_CUMSUM": f"{_TPU_MECHANISM}: the MXU blocked prefix sum (ops.prefix); "
                                 "the port uses torch.cumsum",
    "SPLASHSURF_TPU_DENSITY_PALLAS": "the TPU's choice of the Pallas density sweep or an XLA "
                                     "scan, which give the same densities; the port runs K2 "
                                     "on the card and its plain version on the CPU",
    "SPLASHSURF_TPU_MC_BITMASK": "a formulation of the marching cubes' point compaction that "
                                 "gives the same points; the port has one",
    "SPLASHSURF_TPU_RASTER_SORTFREE": "a formulation of the raster's slot ranks (sort-free or "
                                      "sorted) that gives the same ranks; the port has one",
    "SPLASHSURF_TPU_SLAB_TRACE": "a diagnostic: the slab route's per-slab prints",
    "SPLASHSURF_TPU_SYNC_PROFILE": "a diagnostic: a block after each stage for the profile; "
                                   "the port's is subdomains.enable_profile_sync",
    "SPLASHSURF_TPU_DEBUG_CHECKS": "a diagnostic: a host callback that checks the prefix "
                                   "sum's input range (ops.prefix)",
}
# Switches whose literal defaults differ: name -> (reference's, port's, why)
_DECODE = ("the encoded pull cuts the bytes over a remote TPU link; on the card its "
           "single-core host decode costs more than the copy saves")
DEFAULTS_DIFFER = {
    "SPLASHSURF_TPU_PULL": ("encoded", "packed", _DECODE),
    "SPLASHSURF_TPU_SUB_ENCODED_PULL": ("1", "0", _DECODE + " (the subdomain route stitches)"),
}
# a default that is no literal (an expression of the module)
_NOT_LITERAL = object()


def _literal(node, consts: dict):
    """The value of a literal, or of a module constant bound to one, as the
    environment would give it (a string); ``_NOT_LITERAL`` otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (str, int, float)):
        return str(node.value)
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id]
    return _NOT_LITERAL


def _environ_call(node):
    """(name node, default node or None) of ``<x>.environ.get(name[,
    default])``, ``<x>.getenv(...)`` or ``<x>.environ[name]``; else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.args:
        f = node.func
        if ((f.attr == "get" and isinstance(f.value, ast.Attribute) and f.value.attr == "environ")
                or f.attr == "getenv"):
            return node.args[0], node.args[1] if len(node.args) > 1 else None
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
            and node.value.attr == "environ"):
        return node.slice, None
    return None


def _switch_reads(package: str) -> dict:
    """Every ``SPLASHSURF_TPU_*`` name that a package's source reads from
    the environment, with the set of its defaults (strings, None where a
    read has none, ``_NOT_LITERAL``): from the AST of each module, so a
    name broken across a docstring's lines is no read. A name is a string
    literal, a module constant bound to one, or the literal argument of a
    module function that reads its parameter (``_env_int(name, default)``)."""
    reads: dict = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        tree = ast.parse(path.read_text())
        consts = {t.id: str(n.value.value) for n in tree.body if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  and isinstance(n.value.value, (str, int, float))
                  for t in n.targets if isinstance(t, ast.Name)}
        readers = {}  # function name -> (index of the name, index of the default)
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            params = [a.arg for a in fn.args.args]
            for node in ast.walk(fn):
                call = _environ_call(node)
                if call and isinstance(call[0], ast.Name) and call[0].id in params:
                    d = call[1]
                    readers[fn.name] = (params.index(call[0].id),
                                        params.index(d.id) if isinstance(d, ast.Name)
                                        and d.id in params else None)
        for node in ast.walk(tree):
            call = _environ_call(node)
            if call is None and isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in readers:
                i, j = readers[node.func.id]
                call = (node.args[i], node.args[j] if j is not None and j < len(node.args)
                        else None)
            if call is None:
                continue
            name = _literal(call[0], consts)
            if name is _NOT_LITERAL or not name.startswith("SPLASHSURF_TPU_"):
                continue
            default = None if call[1] is None else _literal(call[1], consts)
            reads.setdefault(name, set()).add(default)
    return reads


REF_SWITCHES = _switch_reads("splashsurf_tpu")
PORT_SWITCHES = _switch_reads("splashsurf_tpu_torch")


def test_the_port_reads_every_switch_of_the_reference_but_not_read():
    assert set(REF_SWITCHES) - set(PORT_SWITCHES) == set(NOT_READ)
    assert set(PORT_SWITCHES) - set(REF_SWITCHES) == set()  # and no switch of its own


@pytest.mark.parametrize("name", sorted(NOT_READ))
def test_not_read_entries_are_real(name):
    assert NOT_READ[name]
    assert name in REF_SWITCHES and name not in PORT_SWITCHES


@pytest.mark.parametrize("name", sorted(set(REF_SWITCHES) & set(PORT_SWITCHES)))
def test_a_switch_has_the_reference_default(name):
    """Where both packages read a switch with literal defaults, they are
    the reference's, but for ``DEFAULTS_DIFFER``."""
    ref = REF_SWITCHES[name] - {None, _NOT_LITERAL}
    port = PORT_SWITCHES[name] - {None, _NOT_LITERAL}
    if not (ref and port):
        return
    if name in DEFAULTS_DIFFER:
        theirs, ours, why = DEFAULTS_DIFFER[name]
        assert why and (ref, port) == ({theirs}, {ours}), name
    else:
        assert ref == port, name


def test_the_switch_scan_sees_every_form_of_read():
    """A spot check of the scan: a read split across lines (``_os``), one
    through a module constant, one through a reading function, literal
    defaults of either type; and a name broken across a docstring's lines
    is no read."""
    assert REF_SWITCHES["SPLASHSURF_TPU_SLAB_MAX_SLABS"] == {"64"}
    assert PORT_SWITCHES["SPLASHSURF_TPU_SLAB_MAX_SLABS"] == {"64"}  # _env_int(..., 64)
    assert PORT_SWITCHES["SPLASHSURF_TPU_DENSITY_GEOSLOT"] == {"1"}  # GEOSLOT_ENV
    assert PORT_SWITCHES["SPLASHSURF_TPU_STREAM_BUDGET_BYTES"] == {"3000000000"}
    assert REF_SWITCHES["SPLASHSURF_TPU_CACHE"] == {_NOT_LITERAL}
    assert not any(n.endswith("_SUB_") for n in REF_SWITCHES.keys() | PORT_SWITCHES.keys())
    assert len(REF_SWITCHES) == 29 and "SPLASHSURF_TPU_MONO_FRAME" in PORT_SWITCHES


def test_the_speculation_names_are_ported():
    """The speculative frame plans' public names, once in ``NOT_PORTED``."""
    from splashsurf_tpu_torch import global_pipeline, neighbors, reconstruction
    from splashsurf_tpu_torch.ops import global_sweep

    assert set(global_pipeline.SPECULATION_STATS) == {
        "frames", "density_miss", "grid_miss", "caps_retry", "overflow_retry"
    }
    for mod, name in ((reconstruction, "GridPlanMiss"), (neighbors, "DensityPlanMiss"),
                      (global_sweep, "SpeculationMiss")):
        assert issubclass(getattr(mod, name), RuntimeError)
    assert callable(reconstruction.clear_grid_plan) and callable(neighbors.clear_density_plan)
    assert callable(global_sweep.PendingPull.resolve)


def test_the_scan_sees_the_newly_ported_names():
    """A spot check that the scan reaches into submodules, constants and
    classes alike."""
    from splashsurf_tpu import density, kernels, neighbors

    assert {"splat_level_set", "RasterizedParticles"} <= _defined_names(density)
    assert "DiscreteSquaredDistanceCubicKernel" in _defined_names(kernels)
    assert {"GATE_LATTICE_MAX", "LAST_GATE", "bin_stats_ex"} <= _defined_names(neighbors)
    assert len(REFERENCE_MODULES) > 40


@pytest.mark.parametrize("name", REFERENCE_SUBMODULES)
def test_reference_submodule_resolves_on_the_port(name):
    assert isinstance(getattr(st, name), types.ModuleType)
    if name in NOT_PORTED:
        with pytest.raises(AttributeError, match=name):
            getattr(pt, name)
        return
    mod = getattr(pt, name)
    assert isinstance(mod, types.ModuleType)
    assert mod.__name__ == f"splashsurf_tpu_torch.{name}"


def test_parallel_loads_lazily_with_the_reference_names():
    from splashsurf_tpu import parallel as jpar

    probe = (
        "import sys, splashsurf_tpu_torch as pt; "
        "assert 'splashsurf_tpu_torch.parallel' not in sys.modules; "
        "pt.parallel; assert 'splashsurf_tpu_torch.parallel' in sys.modules; "
        "assert 'splashsurf_tpu' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=ROOT)
    mod = pt.parallel
    assert mod.__all__ == jpar.__all__ == [
        "make_mesh", "sharded_levelset_step", "sharded_reconstruction_demo"]
    for name in jpar.__all__:
        assert callable(getattr(mod, name))
        assert getattr(mod, name).__module__ == "splashsurf_tpu_torch.parallel.mesh"


def test_unknown_names_raise():
    with pytest.raises(AttributeError, match="no_such_name"):
        pt.no_such_name


@pytest.mark.parametrize("threshold", [0.5, 0.9, 2.0])
def test_density_map_to_hex_mesh_matches_the_reference(threshold):
    rng = np.random.default_rng(7)
    levelset = rng.uniform(0, 1, (7, 8, 9)).astype(np.float32)
    grid = pt.UniformGrid(min=(0.1, -0.2, 0.3), cell_size=0.05, n_cells=(6, 7, 8))
    jgrid = st.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=grid.n_cells)
    got = density_map_to_hex_mesh(levelset, grid, threshold)
    want = ref_hex(levelset, jgrid, threshold)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    hexes = HexMesh3d(vertices=got[0], cells=got[1])
    assert hexes.num_vertices == len(got[0]) == len(np.unique(got[1]))
    assert PointCloud3d(vertices=got[0]).num_vertices == hexes.num_vertices


def test_density_map_to_hex_mesh_shares_corners():
    grid = pt.UniformGrid(min=(0.0, 0.0, 0.0), cell_size=1.0, n_cells=(3, 3, 3))
    ls = np.zeros((4, 4, 4), np.float32)
    ls[1, 1, 1] = 2.0
    ls[2, 1, 1] = 3.0
    verts, cells, vals = density_map_to_hex_mesh(ls, grid, 1.0)
    assert cells.shape == (2, 8)
    assert len(verts) == 12  # two adjacent hexes share 4 corners
    assert sorted(vals.tolist()) == [2.0, 3.0]


class _StubMesh:
    def __init__(self, points, cells, point_data=None):
        self.points = points
        self.cells = cells
        self.point_data = point_data or {}


@pytest.fixture
def stub_meshio(monkeypatch):
    """``meshio`` is not installed: a stub module with its ``Mesh``."""
    stub = types.ModuleType("meshio")
    stub.Mesh = _StubMesh
    monkeypatch.setitem(sys.modules, "meshio", stub)
    return stub


def test_read_bgeo_matches_the_reference(stub_meshio, tmp_path):
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (57, 3)).astype(np.float32)
    attrs = {"velocity": rng.normal(size=(57, 3)).astype(np.float32),
             "density": rng.uniform(900, 1100, 57).astype(np.float32)}
    path = str(tmp_path / "p.bgeo")
    tbgeo_io.write_particles_bgeo(path, pos, attrs)
    got, want = tbgeo.read_bgeo(path), jbgeo.read_bgeo(path)
    assert got.points.dtype == want.points.dtype == np.float64
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.points, pos.astype(np.float64))
    assert [c[0] for c in got.cells] == [c[0] for c in want.cells] == ["vertex"]
    np.testing.assert_array_equal(got.cells[0][1], want.cells[0][1])
    assert sorted(got.point_data) == sorted(want.point_data) == sorted(attrs)
    for k in attrs:
        np.testing.assert_array_equal(got.point_data[k], want.point_data[k])
    # and back: the port's writer, the reference's reader
    again = str(tmp_path / "q.bgeo")
    tbgeo.write_bgeo(again, got)
    back = jbgeo.read_bgeo(again)
    np.testing.assert_array_equal(back.points, want.points)
    for k in attrs:
        np.testing.assert_array_equal(back.point_data[k], want.point_data[k])


def test_register_without_meshio_helpers(stub_meshio):
    assert tbgeo.register() is jbgeo.register() is False


@pytest.fixture(scope="module")
def cloud():
    return np.random.default_rng(0).uniform(0, 1, (1500, 3)).astype(np.float32)


def test_neighborhood_lists_type(cloud):
    nl = pt.neighborhood_search_spatial_hashing_parallel(torch.as_tensor(cloud), 0.1)
    assert isinstance(nl, pt.NeighborhoodLists)
    assert len(nl) == len(cloud)
    assert isinstance(nl[0], np.ndarray)
    assert isinstance(nl.get_neighborhood_lists()[0], list)
    assert nl.offsets.shape == (len(cloud) + 1,) and nl.offsets[-1] == len(nl.indices)


def test_mesh_type_and_connectivity(cloud):
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    mesh = pt.reconstruct_surface(cloud[:400] * 0.02, p, device="cpu").mesh
    np.testing.assert_allclose(
        mesh.vertex_normals_parallel(device="cpu"), mesh.vertex_normals(device="cpu")
    )
    vv = mesh.vertex_vertex_connectivity()
    assert isinstance(vv, pt.VertexVertexConnectivity)
    copied = vv.copy_connectivity()
    assert isinstance(copied[0], list) and len(copied) == len(vv)
    taken = vv.take_connectivity()
    assert len(taken) == len(copied) and len(vv) == 0
    assert pt.MeshWithData(mesh=mesh).mesh_type == pt.MeshType.Tri3d


def test_interpolate_quantity_dispatch(cloud):
    pts = cloud[:400] * 0.02
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    rec = pt.reconstruct_surface(pts, p, device="cpu")
    rho = rec.particle_densities.numpy()
    si = pt.SphInterpolator(pts, rho, p.particle_rest_mass, p.compact_support_radius, device="cpu")
    q = np.asarray(rec.mesh.vertices)[:8]
    s = si.interpolate_quantity(rho, q)
    v = si.interpolate_quantity(np.tile(rho[:, None], (1, 3)), q)
    assert s.shape == (8,) and v.shape == (8, 3)
    np.testing.assert_allclose(v[:, 0], s, rtol=1e-6)


@pytest.fixture(scope="module")
def small_mesh(cloud):
    p = pt.Parameters.new_relative(0.025, 4.0, 1.1)
    return pt.reconstruct_surface(cloud[:400] * 0.02, p, device="cpu")


def _ref_mesh(mesh):
    return st.TriMesh3d(vertices=mesh.vertices.copy(), triangles=mesh.triangles.copy())


@pytest.mark.parametrize(
    "name", ["barnacle_decimation", "marching_cubes_cleanup", "convert_tris_to_quads"]
)
def test_host_aliases_match_the_reference(name, small_mesh):
    """The aliased host edits give their reference namesakes' meshes."""
    rec = small_mesh
    args = ()
    ref_args = ()
    if name == "marching_cubes_cleanup":
        g = rec.grid
        args = (g,)
        ref_args = (st.UniformGrid(min=g.min, cell_size=g.cell_size, n_cells=g.n_cells),)
    got = getattr(pt, name)(rec.mesh, *args)
    want = getattr(st, name)(_ref_mesh(rec.mesh), *ref_args)
    if name == "convert_tris_to_quads":
        assert isinstance(got, pt.MixedTriQuadMesh3d)
        assert 2 * len(got.get_quads()) + len(got.get_triangles()) == rec.mesh.num_triangles
        pairs = ((got.vertices, want.vertices), (got.get_triangles(), want.get_triangles()),
                 (got.get_quads(), want.get_quads()))
    else:
        (gm, gmap), (wm, wmap) = got, want
        assert isinstance(gm, pt.TriMesh3d) and gmap == wmap
        assert pt.check_mesh_consistency(gm.vertices, gm.triangles) is None
        pairs = ((gm.vertices, wm.vertices), (gm.triangles, wm.triangles))
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_smoothing_aliases_match_the_reference(small_mesh):
    mesh = small_mesh.mesh
    weights = np.linspace(0.5, 1.0, mesh.num_vertices).astype(np.float32)
    got = pt.laplacian_smoothing_parallel(mesh.vertices, mesh.triangles, 3, 0.5, weights, device="cpu")
    want = st.laplacian_smoothing_parallel(mesh.vertices, mesh.triangles, 3, 0.5, weights)
    assert not np.array_equal(got, mesh.vertices)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    normals = mesh.vertex_normals(device="cpu")
    got = pt.laplacian_smoothing_normals_parallel(normals, mesh.triangles, mesh.num_vertices, 2, device="cpu")
    want = st.laplacian_smoothing_normals_parallel(normals, mesh.triangles, mesh.num_vertices, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
