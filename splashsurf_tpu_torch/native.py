"""The host collapse engine (C++): Moore/Warren cleanup and the barnacle
decimation's collapse queue (PyTorch port of ``splashsurf_tpu.native``).

The collapse-based post-processing is sequential host work; the C++ engine
(``csrc/host/halfedge.cpp``) runs it over flat arrays, loaded via ctypes. It
is built with ``g++`` into ``_build/`` at first use, under a temporary name
that is then renamed into place, so that processes building at the same time
never load a half-written library. Without a compiler the callers fall back
to the pure-Python half-edge code, with a warning.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "host" / "halfedge.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
_LIB = _BUILD_DIR / "libhalfedge_host.so"
_LOCK = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _warn_fallback(reason: str) -> None:
    import warnings

    warnings.warn(
        "splashsurf_tpu_torch native half-edge engine unavailable "
        f"({reason}); falling back to the pure-Python implementation — "
        "mesh cleanup/decimation will be MUCH slower on large meshes",
        RuntimeWarning,
        stacklevel=3,
    )


def load():
    """Load (building on first use) the native library, or None."""
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                _warn_fallback("g++ build failed or no compiler available")
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            _warn_fallback(f"could not load {_LIB}: {e}")
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
