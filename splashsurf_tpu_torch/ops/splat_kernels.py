"""The hand-written CUDA kernels, their plain PyTorch versions, and the
build and loader.

Port of ``splashsurf_tpu/ops/splat_pallas.py``:

- ``sweep_global_cuda`` (K1, ``csrc/sweep_global.cu``) replaces
  ``sweep_global_pallas``; its plain version ``sweep_global_plain`` is the
  scan formulation of ``global_sweep.sweep_global``.
- ``density_sweep_cuda`` (K2, ``csrc/density_sweep.cu``) replaces
  ``density_sweep_pallas``; its plain version ``density_sweep_plain`` is
  ``neighbors._raster_sweep_xla``.
- ``splat_sweep_cuda`` (K3, ``csrc/splat_sweep.cu``) replaces
  ``splat_sweep_pallas``; its plain version ``splat_sweep_plain`` is the
  scan formulation of ``subdomains.chunk_levelset_raster``. K1 and K3 share
  their per-point sum (``csrc/level_set_sum.cuh``).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches its kernel on the current stream or raises; it never falls back.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernels evaluate q = sqrt(d2) * (2/h) and scale once at the end; the
plain versions go through ``kernels.cubic_kernel`` (q = (r + r) / h, scaled
per term), so the two agree to rounding, not bit for bit.

The library is built with ``nvcc`` for ``sm_90a`` into ``_build/`` at first
use, one compiler process per source, all started together, and rebuilt
when a source or header is newer than it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch.density import gather_cell_offsets

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = tuple(
    _CSRC / name for name in ("sweep_global.cu", "density_sweep.cu", "splat_sweep.cu")
)
_HEADERS = (_CSRC / "level_set_sum.cuh",)
_BUILD_DIR = _PKG / "_build"
_LIB = _BUILD_DIR / "libsplat_kernels.so"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    return None


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libsplat_kernels.so`` unless the
    library is newer than every source and header: one ``nvcc -c`` per
    source, all running at once, then one link. The compiler's report
    (registers, spills) is kept in ``_build/build.log``. Raises RuntimeError
    when ``nvcc`` is missing or the build fails."""
    newest = max(s.stat().st_mtime for s in _SOURCES + _HEADERS)
    if _LIB.exists() and _LIB.stat().st_mtime >= newest:
        return _LIB
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (searched $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in _SOURCES]
    cmds = [
        [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(_SOURCES, objs)
    ]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    reports = [p.communicate()[0] for p in procs]
    tmp = _BUILD_DIR / f"libsplat_kernels.{tag}.so"
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        reports.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = [link]
    log = "".join(" ".join(c) + "\n" + r for c, r in zip(cmds + [link], reports))
    (_BUILD_DIR / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{log}")
    os.replace(tmp, _LIB)  # atomic: a concurrent loader sees old or new
    return _LIB


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises RuntimeError
    when it cannot be built or loaded."""
    path = build_kernels()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    p, i, i64, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    for name in ("sweep_global_f32", "sweep_global_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i, i, i64, i64, i64, i64, i64, i64,
                       i, d, d, p, p]
        fn.restype = i
    for name in ("density_sweep_f32", "density_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i64, i64, i64, d, d, p, p]
        fn.restype = i
    for name in ("splat_sweep_f32", "splat_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i, i, i64, i64, i64, i, d, d, p, p]
        fn.restype = i
    return lib


def _check_inputs(tensors, what: str, ndim: int = 4):
    """The kernels take contiguous ``ndim``-D float32/float64 tensors of one
    shape, device and dtype."""
    t0 = tensors[0]
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {t0.dtype} (want float32 or float64)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{what}: inputs differ in device or dtype")
        if t.shape != t0.shape or t.dim() != ndim:
            raise ValueError(f"{what}: shapes {[tuple(x.shape) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} at launch")


def _suffix(dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


# ---------------------------------------------------------------------------
# K1: level-set sweep
# ---------------------------------------------------------------------------


def offset_runs(hsc: int, pad: int | None = None) -> np.ndarray:
    """The pruned cell-offset fan of ``gather_cell_offsets(hsc)``, shifted
    by ``pad`` (default hsc + 1), as runs (o0, o1, o2_lo, o2_hi): for fixed
    (o0, o1) the kept o2 form one contiguous range [o2_lo, o2_hi)."""
    offs = gather_cell_offsets(hsc) + (hsc + 1 if pad is None else pad)
    runs = []
    for o0, o1 in sorted({(int(a), int(b)) for a, b, _ in offs}):
        o2 = np.sort(offs[(offs[:, 0] == o0) & (offs[:, 1] == o1), 2])
        if not np.array_equal(o2, np.arange(o2[0], o2[-1] + 1)):
            raise AssertionError(f"offset fan not contiguous at {(o0, o1)}")
        runs.append((o0, o1, int(o2[0]), int(o2[-1]) + 1))
    return np.asarray(runs, np.int32)


@functools.lru_cache(maxsize=16)
def _runs_on(hsc: int, pad: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(offset_runs(hsc, pad), device=device)


def _level_set_plain(fx, fy, fz, fv, cell_size, compact_support_radius, hsc, pad, n_points):
    """The scan formulation shared by the plain K1 and K3: rasters (...,
    S, Xp, Yp, Zp) in, the (..., PX, PY, PZ) sums over the slots and the
    fan ``gather_cell_offsets(hsc)`` shifted by ``pad`` out."""
    t = kernels.np_dtype(fx.dtype).type
    lead = fx.shape[:-4]
    acc = torch.zeros(lead + tuple(n_points), dtype=fx.dtype, device=fx.device)
    for o in gather_cell_offsets(hsc) + pad:
        sl = (...,) + tuple(slice(int(a), int(a) + n) for a, n in zip(o, n_points))
        # per-axis offset (o - pad) * cs, formed in the rasters' precision
        od = [float(t(a - pad) * t(cell_size)) for a in o]
        dx, dy, dz = fx[sl] + od[0], fy[sl] + od[1], fz[sl] + od[2]
        d2 = dx * dx + dy * dy + dz * dz
        w = kernels.cubic_kernel(torch.sqrt(d2), compact_support_radius) * fv[sl]
        acc += torch.sum(w, dim=-4)
    return acc


def sweep_global_plain(fx, fy, fz, fv, cell_size, compact_support_radius, hsc, n_points):
    """Plain PyTorch level-set sweep: the scan formulation of the reference
    (``global_sweep.sweep_global``, backend "scan"). Returns (PX, PY, PZ)."""
    return _level_set_plain(
        fx, fy, fz, fv, cell_size, compact_support_radius, hsc, hsc + 1, n_points
    )


def sweep_global_cuda(fx, fy, fz, fv, cell_size, compact_support_radius, hsc, n_points):
    """Level set on the (PX, PY, PZ) points from the (S, Xp, Yp, Zp) slot
    rasters of ``rasterize_global``: kernel K1 on CUDA tensors, the plain
    version on CPU tensors."""
    _check_inputs((fx, fy, fz, fv), "sweep_global")
    if fx.device.type == "cpu":
        return sweep_global_plain(
            fx, fy, fz, fv, cell_size, compact_support_radius, hsc, n_points
        )
    if fx.device.type != "cuda":
        raise ValueError(f"sweep_global: unsupported device {fx.device}")
    S, Xp, Yp, Zp = fx.shape
    PX, PY, PZ = (int(v) for v in n_points)
    pad = hsc + 1
    if Xp < PX + 2 * pad - 1 or Yp < PY + 2 * pad - 1 or Zp < PZ + 2 * pad - 1:
        raise ValueError(f"sweep_global: rasters {tuple(fx.shape)} too small for {n_points}")
    lib = load_kernels()
    runs = _runs_on(hsc, pad, fx.device)
    out = torch.empty((PX, PY, PZ), dtype=fx.dtype, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "sweep_global_" + _suffix(fx.dtype)),
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), fv.data_ptr(),
            runs.data_ptr(), runs.shape[0], S, Xp, Yp, Zp, PX, PY, PZ, pad,
            float(cell_size), float(compact_support_radius), out.data_ptr(),
            stream,
        )
    sweep_global_cuda.launches += 1
    return out


sweep_global_cuda.launches = 0


# ---------------------------------------------------------------------------
# K2: per-particle density sweep over the bin lattice
# ---------------------------------------------------------------------------


def density_sweep_plain(fx, fy, fz, LX, bin_size, compact_support_radius):
    """Plain PyTorch 27-offset bin sweep: ``neighbors._raster_sweep_xla`` of
    the reference. Rasters (slots, LX+2, Yp, Zp) in; acc (slots, LX, W) out,
    W = (Yp - 2) * Zp."""
    slots, _, Yp, Zp = fx.shape
    dtype = fx.dtype
    t = kernels.np_dtype(dtype).type
    W = (Yp - 2) * Zp
    far = kernels.far_fill(dtype)
    # +2 tail lanes: the widest window (shift 2*Zp+2, width W) ends exactly
    # 2 lanes past Yp*Zp
    flat = [
        torch.nn.functional.pad(
            r.reshape(slots, LX + 2, Yp * Zp), (0, 2), value=far
        )
        for r in (fx, fy, fz)
    ]
    fq = [r[:, 1 : 1 + LX, Zp + 1 : Zp + 1 + W] for r in flat]
    acc = torch.zeros((slots, LX, W), dtype=dtype, device=fx.device)
    for o0 in (0, 1, 2):
        for o1 in (0, 1, 2):
            for o2 in (0, 1, 2):
                shift = o1 * Zp + o2
                wins = [f[:, o0 : o0 + LX, shift : shift + W] for f in flat]
                # (o - 1) * bs per axis, formed in the rasters' precision
                ods = [float(t(o - 1) * t(bin_size)) for o in (o0, o1, o2)]
                for kj in range(slots):
                    d2 = torch.zeros((slots, LX, W), dtype=dtype, device=fx.device)
                    for d in range(3):
                        # empty slots: far fracs -> W = 0 exactly; NaNs
                        # (inf - inf) only reach empty query slots, which the
                        # read-back never reads
                        diff = fq[d] - (wins[d][kj] + ods[d])[None]
                        d2 = d2 + diff * diff
                    acc += kernels.cubic_kernel(torch.sqrt(d2), compact_support_radius)
    return acc


def density_sweep_cuda(fx, fy, fz, LX, bin_size, compact_support_radius):
    """Per-(slot, bin) SPH density sums from the (8, LX+2, Yp, Zp) bin
    rasters: kernel K2 on CUDA tensors, the plain version on CPU tensors.
    Returns (8, LX, (Yp - 2) * Zp) sums of the normalized kernel W."""
    _check_inputs((fx, fy, fz), "density_sweep")
    if fx.device.type == "cpu":
        return density_sweep_plain(fx, fy, fz, LX, bin_size, compact_support_radius)
    if fx.device.type != "cuda":
        raise ValueError(f"density_sweep: unsupported device {fx.device}")
    slots, Xp, Yp, Zp = fx.shape
    if slots != 8 or Xp != LX + 2:
        raise ValueError(f"density_sweep: rasters {tuple(fx.shape)} for LX={LX}")
    lib = load_kernels()
    out = torch.empty((slots, LX, (Yp - 2) * Zp), dtype=fx.dtype, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "density_sweep_" + _suffix(fx.dtype)),
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), LX, Yp, Zp,
            float(bin_size), float(compact_support_radius), out.data_ptr(),
            stream,
        )
    density_sweep_cuda.launches += 1
    return out


density_sweep_cuda.launches = 0


# ---------------------------------------------------------------------------
# K3: per-subdomain level-set sweep
# ---------------------------------------------------------------------------


def splat_sweep_plain(rx, ry, rz, rv, cell_size, compact_support_radius, hsc, margin, n_points):
    """Plain PyTorch per-subdomain sweep: the scan formulation of the
    reference's ``chunk_levelset_raster(..., unroll=False)``. Rasters (C, S,
    Rp, Rp, Rp) in, level sets (C, P, P, P) out, P = ``n_points``."""
    P = int(n_points)
    return _level_set_plain(
        rx, ry, rz, rv, cell_size, compact_support_radius, hsc, margin + 1, (P, P, P)
    )


def splat_sweep_cuda(rx, ry, rz, rv, cell_size, compact_support_radius, hsc, margin, n_points):
    """Level sets (C, P, P, P) of the C subdomains of a chunk from their
    padded (C, S, Rp, Rp, Rp) slot rasters, Rp = P + 2 * margin + 1 (the
    subdomain's cells, its ghost margin and one empty cell per side): kernel
    K3 on CUDA tensors, the plain version on CPU tensors."""
    _check_inputs((rx, ry, rz, rv), "splat_sweep", ndim=5)
    if rx.device.type == "cpu":
        return splat_sweep_plain(
            rx, ry, rz, rv, cell_size, compact_support_radius, hsc, margin, n_points
        )
    if rx.device.type != "cuda":
        raise ValueError(f"splat_sweep: unsupported device {rx.device}")
    C, S, Rp = rx.shape[:3]
    P = int(n_points)
    pad = margin + 1
    if rx.shape[2:] != (Rp, Rp, Rp) or Rp != P + 2 * pad - 1 or margin < hsc:
        raise ValueError(
            f"splat_sweep: rasters {tuple(rx.shape)} for P={P}, margin={margin}, hsc={hsc}"
        )
    lib = load_kernels()
    runs = _runs_on(hsc, pad, rx.device)
    out = torch.empty((C, P, P, P), dtype=rx.dtype, device=rx.device)
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "splat_sweep_" + _suffix(rx.dtype)),
            rx.data_ptr(), ry.data_ptr(), rz.data_ptr(), rv.data_ptr(),
            runs.data_ptr(), runs.shape[0], S, C, Rp, P, pad,
            float(cell_size), float(compact_support_radius), out.data_ptr(),
            stream,
        )
    splat_sweep_cuda.launches += 1
    return out


splat_sweep_cuda.launches = 0
