"""The host engines in C++ (PyTorch port of ``splashsurf_tpu.native``):
the collapse engine (Moore/Warren cleanup and the barnacle decimation's
collapse queue, ``csrc/host/halfedge.cpp``) and the decoder of the encoded
marching-cubes streams (``csrc/host/mc_decode.cpp``).

The collapse-based post-processing and the mesh decode are sequential host
work over flat arrays, loaded via ctypes. Each source is built with ``g++``
into ``_build/`` at first use, under a temporary name that is then renamed
into place, so that processes building at the same time never load a
half-written library. Without a compiler the callers fall back to Python:
the pure-Python half-edge code, and the numpy decoders
(``ops.global_sweep._decode_cellwise_mesh``,
``subdomains._decode_sub_mesh_np``), each with a warning.

The decoder's point ids are int64 (the reference's ``unpack_compact``
writes int32 ids, which wrap past 2^31 points); its ranks into the
active-point list and its triangles' vertex indices are int32, as the
reference's (fewer than 2^31 active points and vertices, checked). ``DECODE_STATS`` counts the decodes
that ran natively and in numpy.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "host" / "halfedge.cpp"
_DECODE_SRC = _HERE / "csrc" / "host" / "mc_decode.cpp"
_BUILD_DIR = _HERE / "_build"
_LIB = _BUILD_DIR / "libhalfedge_host.so"
_DECODE_LIB = _BUILD_DIR / "libmc_decode_host.so"
_LOCK = threading.Lock()
_lib = None
_tried = False
_decode_lib = None
_decode_tried = False

# decodes run per engine since the process started (or a caller zeroed them)
DECODE_STATS = {"native": 0, "numpy": 0}


def _build(src: pathlib.Path, lib: pathlib.Path) -> bool:
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, lib)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _open(src: pathlib.Path, lib: pathlib.Path, what: str):
    """The library built from ``src`` (building it when it is missing or
    older than its source), or None with a warning naming ``what`` falls
    back."""
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        if not _build(src, lib):
            _warn_fallback(what, "g++ build failed or no compiler available")
            return None
    try:
        return ctypes.CDLL(str(lib))
    except OSError as e:
        _warn_fallback(what, f"could not load {lib}: {e}")
        return None


def _warn_fallback(what: str, reason: str) -> None:
    import warnings

    warnings.warn(
        f"splashsurf_tpu_torch native {what} unavailable ({reason}); falling "
        "back to the Python implementation, MUCH slower on large meshes",
        RuntimeWarning,
        stacklevel=4,
    )


def load():
    """Load (building on first use) the native library, or None."""
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _open(_SRC, _LIB, "half-edge engine")
        if lib is None:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.mc_cleanup.restype = ctypes.c_int64
        lib.mc_cleanup.argtypes = [
            f64p, ctypes.c_int64, i64p, ctypes.c_int64,
            i64p, f64p, ctypes.c_double, ctypes.c_int64, u8p, i64p,
        ]
        lib.process_collapses.restype = ctypes.c_int64
        lib.process_collapses.argtypes = [
            f64p, ctypes.c_int64, i64p, ctypes.c_int64,
            i64p, ctypes.c_int64, u8p, i64p,
        ]
        lib.vertex_ring_sizes.restype = None
        lib.vertex_ring_sizes.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def load_decoder():
    """Load (building on first use) the native mesh decoder, or None."""
    global _decode_lib, _decode_tried
    with _LOCK:
        if _decode_lib is not None or _decode_tried:
            return _decode_lib
        _decode_tried = True
        lib = _open(_DECODE_SRC, _DECODE_LIB, "mesh decoder")
        if lib is None:
            return None
        nd = np.ctypeslib.ndpointer
        f32p, i32p, i64p = nd(np.float32, flags="C"), nd(np.int32, flags="C"), nd(np.int64, flags="C")
        u8p, u16p, u32p = nd(np.uint8, flags="C"), nd(np.uint16, flags="C"), nd(np.uint32, flags="C")
        i8p = nd(np.int8, flags="C")
        i64, f64 = ctypes.c_int64, ctypes.c_double
        luts = [i8p, i64, u8p, i8p, i8p, f32p, i32p]  # tables, then the outputs
        lib.mc_decode.restype = i64
        lib.mc_decode.argtypes = [
            f32p, i64, i64, i64p, u16p, i64, i64, i64, f64, f64, f64, f64, *luts,
        ]
        lib.mc_decode_sub.restype = i64
        lib.mc_decode_sub.argtypes = [
            f32p, i64, i64, u32p, i64, i32p, i32p, i64, i64, i64, i64,
            f64, f64, f64, f64, *luts,
        ]
        lib.unpack_compact.restype = i64
        lib.unpack_compact.argtypes = [u16p, i64, u8p, i64, i64, i64p, u16p]
        _decode_lib = lib
        return _decode_lib


@functools.cache
def _lut_arrays():
    """The marching-cubes tables as the decoder reads them: (TRI_TABLE with
    -1 as 0, int8; TRI_COUNT, uint8; EDGE_AXIS, int8; EDGE_BASE_OFFSET,
    int8)."""
    from splashsurf_tpu_torch.mc import lut

    tri_table = np.ascontiguousarray(np.where(lut.TRI_TABLE >= 0, lut.TRI_TABLE, 0), np.int8)
    return (
        tri_table,
        np.ascontiguousarray(lut.TRI_COUNT, np.uint8),
        np.ascontiguousarray(lut.EDGE_AXIS, np.int8),
        np.ascontiguousarray(lut.EDGE_BASE_OFFSET, np.int8),
    )


def _outputs(total_v: int, total_t: int, total_c: int):
    if max(total_v, total_c) > np.iinfo(np.int32).max:
        raise ValueError(f"{total_v} vertices or {total_c} active points do not fit int32 indices")
    return np.empty((max(total_v, 1), 3), np.float32), np.empty((max(total_t, 1), 3), np.int32)


def mc_decode(t, points, words, total_v: int, total_t: int, total_c: int,
              PY: int, PZ: int, grid_min, cell_size: float):
    """Decode the dense route's encoded streams, (t, points, words), into
    (vertices (V, 3) f32, triangles (T, 3) int32), the mesh of the unencoded
    path (up to the device's multiply-add in the vertex positions). Points
    are int64 flat ids. Returns None when the native library is
    unavailable (the caller takes the numpy decoder)."""
    lib = load_decoder()
    if lib is None:
        return None
    t = np.ascontiguousarray(np.asarray(t)[:total_v], dtype=np.float32)
    points = np.ascontiguousarray(np.asarray(points)[:total_c], dtype=np.int64)
    words = np.ascontiguousarray(np.asarray(words)[:total_c], dtype=np.uint16)
    tri_table, tri_count, edge_axis, edge_base = _lut_arrays()
    verts, tris = _outputs(total_v, total_t, total_c)
    n = lib.mc_decode(
        t, total_v, total_t, points, words, total_c, PY, PZ,
        float(grid_min[0]), float(grid_min[1]), float(grid_min[2]), float(cell_size),
        tri_table, tri_table.shape[1], tri_count, edge_axis, edge_base, verts, tris,
    )
    if n != total_t:
        raise RuntimeError(f"native mc_decode inconsistency: wrote {n} of {total_t} triangles")
    DECODE_STATS["native"] += 1
    return verts[:total_v], tris[:total_t]


def mc_decode_sub(t, packed, run_counts, run_base, total_v: int, total_t: int,
                  ns: int, NPY: int, NPZ: int, grid_min, cell_size: float,
                  quant_t: bool):
    """Decode the subdomain route's owned-point streams (``packed`` u32
    words in runs of ``run_counts`` points at subdomain bases ``run_base``
    (R, 3), and the point-major edge parameters ``t``, u16 when
    ``quant_t``) into (vertices f32, triangles int32). Returns None when the
    native library is unavailable."""
    lib = load_decoder()
    if lib is None:
        return None
    t = np.asarray(t)
    if quant_t:
        t = t.astype(np.float32) * np.float32(1.0 / 65535.0)
    t = np.ascontiguousarray(t, dtype=np.float32)
    packed = np.ascontiguousarray(np.asarray(packed), dtype=np.uint32)
    run_counts = np.ascontiguousarray(run_counts, dtype=np.int32)
    run_base = np.ascontiguousarray(run_base, dtype=np.int32)
    tri_table, tri_count, edge_axis, edge_base = _lut_arrays()
    verts, tris = _outputs(total_v, total_t, packed.shape[0])
    n = lib.mc_decode_sub(
        t, total_v, total_t, packed, packed.shape[0], run_counts, run_base,
        run_counts.shape[0], ns, NPY, NPZ,
        float(grid_min[0]), float(grid_min[1]), float(grid_min[2]), float(cell_size),
        tri_table, tri_table.shape[1], tri_count, edge_axis, edge_base, verts, tris,
    )
    if n != total_t:
        raise RuntimeError(f"native mc_decode_sub inconsistency: wrote {n} of {total_t} triangles")
    DECODE_STATS["native"] += 1
    return verts[:total_v], tris[:total_t]


def unpack_compact(packed, bsum, total_c: int, point_offset: int = 0):
    """Native inverse of the packed point compaction: (points int64, words
    uint16) from the u16 packed stream and the u8 per-block counts, the ids
    offset by ``point_offset``. Returns None when the native library is
    unavailable."""
    lib = load_decoder()
    if lib is None:
        return None
    packed = np.ascontiguousarray(np.asarray(packed)[:total_c], np.uint16)
    bsum = np.ascontiguousarray(np.asarray(bsum), np.uint8)
    points = np.empty(max(total_c, 1), np.int64)
    words = np.empty(max(total_c, 1), np.uint16)
    r = lib.unpack_compact(packed, total_c, bsum, bsum.shape[0], int(point_offset), points, words)
    if r != 0:
        raise RuntimeError("native unpack_compact inconsistency")
    return points[:total_c], words[:total_c]


def mc_cleanup(vertices, triangles, nearest_grid_point, grid_coords,
               max_snap_distance_sq: float, max_iter: int):
    """Run the native Moore/Warren cleanup. Returns
    (vertices, triangles_raw, tri_valid, vert_owner, n_collapses)."""
    lib = load()
    verts = np.array(vertices, dtype=np.float64, order="C")
    tris = np.array(triangles, dtype=np.int64, order="C")
    ngp = np.ascontiguousarray(nearest_grid_point, dtype=np.int64)
    gc = np.ascontiguousarray(grid_coords, dtype=np.float64)
    tri_valid = np.zeros(len(tris), np.uint8)
    owner = np.zeros(len(verts), np.int64)
    n = lib.mc_cleanup(
        verts, len(verts), tris, len(tris), ngp, gc,
        float(max_snap_distance_sq), int(max_iter), tri_valid, owner,
    )
    return verts, tris, tri_valid.astype(bool), owner, int(n)


def process_collapses(vertices, triangles, pairs):
    """Run a legality-checked collapse queue natively."""
    lib = load()
    verts = np.array(vertices, dtype=np.float64, order="C")
    tris = np.array(triangles, dtype=np.int64, order="C")
    pr = np.ascontiguousarray(pairs, dtype=np.int64).reshape(-1)
    tri_valid = np.zeros(len(tris), np.uint8)
    owner = np.zeros(len(verts), np.int64)
    n = lib.process_collapses(
        verts, len(verts), tris, len(tris), pr, len(pr) // 2, tri_valid, owner
    )
    return verts, tris, tri_valid.astype(bool), owner, int(n)


def vertex_ring_sizes(triangles, num_vertices: int) -> np.ndarray:
    lib = load()
    tris = np.ascontiguousarray(triangles, dtype=np.int64)
    out = np.zeros(num_vertices, np.int64)
    lib.vertex_ring_sizes(tris, len(tris), num_vertices, out)
    return out
