"""The hand-written CUDA kernels, their plain PyTorch versions, and the
build and loader.

Port of ``splashsurf_tpu/ops/splat_pallas.py``:

- ``sweep_global_cuda`` (K1, ``csrc/sweep_global.cu``) replaces
  ``sweep_global_pallas``; its plain version ``sweep_global_plain`` is the
  scan formulation of ``global_sweep.sweep_global``.
- ``occupancy_masks_cuda`` (the pre-pass of K1, K3 and K4, in
  ``csrc/sweep_global.cu``) packs one bit per raster entry with a nonzero
  weight, or for K4 a fraction below the empty sentinel; its plain version
  is ``occupancy_masks_plain``.
- ``density_sweep_cuda`` (K2, ``csrc/density_sweep.cu``) replaces
  ``density_sweep_pallas``; its plain version ``density_sweep_plain`` is
  ``neighbors._raster_sweep_xla``. Its pre-pass ``bin_occupancy_cuda``
  (plain ``bin_occupancy_plain``) packs each bin's occupied slots into a
  byte; the kernel loads only occupied sources, its warps taking the
  source slots in step.
- ``splat_sweep_cuda`` (K3, ``csrc/splat_sweep.cu``) replaces
  ``splat_sweep_pallas``; its plain version ``splat_sweep_plain`` is the
  scan formulation of ``subdomains.chunk_levelset_raster``. K1 and K3 share
  one tiled kernel (``csrc/level_set_sum.cuh``) that walks the set bits of
  the occupancy masks only.
- ``pair_sweep_cuda`` (K4, ``csrc/pair_sweep.cu``) replaces
  ``pair_sweep_pallas``; its plain version ``pair_sweep_plain`` is
  ``global_sweep._pair_sweep_xla``, over the reference's fan
  ``pair_cell_offsets``. Its tiles gather their occupied queries into a
  list and walk the set bits of the fraction masks only.

K2 and K4 skip the square root and the spline of a pair beyond
``support_cut2``: such a pair's term is exactly +0, so the sums are
unchanged.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches its kernel on the current stream or raises; it never falls back.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernels evaluate q = sqrt(d2) * (2/h) and scale once at the end; the
plain versions of K1-K3 go through ``kernels.cubic_kernel`` (q = (r + r) / h,
scaled per term), so the two agree to rounding, not bit for bit. K4's plain
version uses the kernel's form, as its reference does.

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
    _CSRC / name for name in (
        "sweep_global.cu", "density_sweep.cu", "splat_sweep.cu", "pair_sweep.cu",
    )
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
    for name in ("occupancy_masks_f32", "occupancy_masks_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i64, i64, i64, i, p, p]
        fn.restype = i
    for name in ("bin_occupancy_f32", "bin_occupancy_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i64, p, p]
        fn.restype = i
    for name in ("sweep_global_f32", "sweep_global_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i64, i64, i64, i64, i64, i64, i64,
                       i, d, d, p, p]
        fn.restype = i
    for name in ("density_sweep_f32", "density_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i64, i64, i64, d, d, d, p, p]
        fn.restype = i
    for name in ("splat_sweep_f32", "splat_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i64, i64, i64, i64, i, d, d, p, p]
        fn.restype = i
    for name in ("pair_sweep_f32", "pair_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i64, i64, i64, i,
                       d, d, d, p, p]
        fn.restype = i
    for name in ("sweep_geometry", "pair_sweep_geometry"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, i, i, p]
        fn.restype = None
    return lib


def kernel_geometry(kind: str, n_runs: int, n_slots: int, pad: int, dtype):
    """The block geometry that the built library launches: the tile (x, y,
    z), the mask words staged per window row and the dynamic shared memory
    bytes of one block, for the level-set sweep (``kind`` "sweep", K1 and
    K3; ``pad`` the raster pad) or K4 (``"pair_sweep"``; ``pad`` the reach).
    ``SWEEP_TILE``, ``window_words``, ``PAIR_TILE`` and ``pair_window_words``
    are the host's copies, for the CPU emulations."""
    out = (ctypes.c_int64 * 5)()
    t_size = torch.empty((), dtype=dtype).element_size()
    getattr(load_kernels(), kind + "_geometry")(n_runs, n_slots, pad, t_size, out)
    return tuple(out[:3]), out[3], out[4]


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


# Relative slack of the pair kernels' distance cut, far above the rounding
# of d2, sqrt and q (a few units in the last place of f32)
CUT_SLACK = 1e-4


def support_cut2(compact_support_radius, dtype) -> float:
    """The squared distance past which K2 and K4 skip a pair's square root
    and spline, h^2 (1 + CUT_SLACK) in the rasters' precision (as the
    kernels hold it). A pair beyond it has q = sqrt(d2) * (2/h) > 2 in
    their arithmetic, so its term is exactly +0 and the cut leaves every
    sum unchanged bit for bit."""
    h = float(compact_support_radius)
    return kernels.rounded(h * h * (1.0 + CUT_SLACK), dtype)


# ---------------------------------------------------------------------------
# K1: level-set sweep
# ---------------------------------------------------------------------------


def _runs(offs: np.ndarray) -> np.ndarray:
    """A fan of (o0, o1, o2) offsets in meshgrid order as runs (o0, o1,
    o2_lo, o2_hi), one per (o0, o1) in ascending order: the kept o2 must form
    one contiguous range [o2_lo, o2_hi)."""
    runs = []
    for o0, o1 in sorted({(int(a), int(b)) for a, b, _ in offs}):
        o2 = np.sort(offs[(offs[:, 0] == o0) & (offs[:, 1] == o1), 2])
        if not np.array_equal(o2, np.arange(o2[0], o2[-1] + 1)):
            raise AssertionError(f"offset fan not contiguous at {(o0, o1)}")
        runs.append((o0, o1, int(o2[0]), int(o2[-1]) + 1))
    return np.asarray(runs, np.int32)


def offset_runs(hsc: int, pad: int | None = None) -> np.ndarray:
    """The pruned cell-offset fan of ``gather_cell_offsets(hsc)``, shifted
    by ``pad`` (default hsc + 1), as runs (see ``_runs``)."""
    return _runs(gather_cell_offsets(hsc) + (hsc + 1 if pad is None else pad))


def split_runs(runs: np.ndarray, longest: int = 32) -> np.ndarray:
    """Runs cut into pieces of at most ``longest`` o2, in order: the sweep
    kernel takes a run's bits from one 32-bit funnel."""
    out = []
    for o0, o1, lo, hi in runs.tolist():
        out.extend((o0, o1, a, min(a + longest, hi)) for a in range(lo, hi, longest))
    return np.asarray(out, np.int32).reshape(-1, 4)


def sweep_runs(hsc: int, pad: int, h_over_cs: float) -> np.ndarray:
    """The run table of the sweep kernels: the fan ``gather_cell_offsets(hsc)``
    less the cells that lie wholly beyond the support radius (their terms
    are exactly 0: every particle in them is at q >= 2), shifted by ``pad``,
    in runs of at most 32. The kept offsets keep their order, so the sum
    over them equals the sum over the whole fan."""
    offs = gather_cell_offsets(hsc)
    d = np.where(offs > 0, offs, np.where(offs + 1 < 0, -(offs + 1), 0)).astype(np.float64)
    keep = (d**2).sum(axis=1) < (h_over_cs * (1.0 + 1e-3)) ** 2
    return split_runs(_runs(offs[keep] + pad))


@functools.lru_cache(maxsize=16)
def _runs_on(hsc: int, pad: int, h_over_cs: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sweep_runs(hsc, pad, h_over_cs), device=device)


# The sweep kernel's tile (csrc/level_set_sum.cuh kTileX, kTileY, 32 z):
# one warp per (x, y) row segment of 32 consecutive z. The library reports
# its own through kernel_geometry.
SWEEP_TILE = (2, 4, 32)


def window_words(pad: int) -> int:
    """Mask words the sweep kernel stages per window row
    (``window_words`` in level_set_sum.cuh): the tile's 32 z plus 2 pad - 1,
    and one more for the funnel."""
    return ((2 * pad + 30) >> 5) + 2


def _occupied(values: torch.Tensor, fractions: bool) -> torch.Tensor:
    """The kernels' occupancy test: a fraction below the empty sentinel (an
    occupied fraction lies within one cell or bin), or a nonzero weight."""
    return values < 1e14 if fractions else values != 0


def occupancy_masks_plain(fv: torch.Tensor, fractions: bool = False) -> torch.Tensor:
    """Plain PyTorch occupancy masks: values (..., Zp) in, int32 words
    (..., ceil(Zp / 32)) out, bit b of word w set iff fv[..., 32 w + b] is
    occupied: != 0 for weights, < 1e14 with ``fractions`` (the kernel's
    words, read as signed)."""
    Zp = fv.shape[-1]
    W = -(-Zp // 32)
    occ = torch.nn.functional.pad(_occupied(fv, fractions).to(torch.int64), (0, 32 * W - Zp))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=fv.device),
        torch.arange(32, device=fv.device),
    )
    words = (occ.reshape(fv.shape[:-1] + (W, 32)) * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def occupancy_masks_cuda(fv: torch.Tensor, fractions: bool = False) -> torch.Tensor:
    """Occupancy masks of the weight raster ``fv`` (..., Zp), or with
    ``fractions`` of a fraction raster: the pre-pass kernel of K1, K3 and
    K4 on a CUDA tensor, the plain version on a CPU one. Returns int32 words
    (..., ceil(Zp / 32)) as ``occupancy_masks_plain``."""
    if fv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"occupancy_masks: dtype {fv.dtype} (want float32 or float64)")
    if fv.dim() == 0 or not fv.is_contiguous():
        raise ValueError("occupancy_masks: the values must be contiguous, at least 1-D")
    if fv.device.type == "cpu":
        return occupancy_masks_plain(fv, fractions)
    if fv.device.type != "cuda":
        raise ValueError(f"occupancy_masks: unsupported device {fv.device}")
    Zp = fv.shape[-1]
    W = -(-Zp // 32)
    lib = load_kernels()
    out = torch.empty(fv.shape[:-1] + (W,), dtype=torch.int32, device=fv.device)
    with torch.cuda.device(fv.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "occupancy_masks_" + _suffix(fv.dtype)),
            fv.data_ptr(), fv.numel() // max(Zp, 1), Zp, W, int(fractions),
            out.data_ptr(), stream,
        )
    occupancy_masks_cuda.launches += 1
    return out


occupancy_masks_cuda.launches = 0


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
    runs = _runs_on(hsc, pad, float(compact_support_radius) / float(cell_size), fx.device)
    masks = occupancy_masks_cuda(fv)
    out = torch.empty((PX, PY, PZ), dtype=fx.dtype, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "sweep_global_" + _suffix(fx.dtype)),
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), fv.data_ptr(),
            masks.data_ptr(), runs.data_ptr(), runs.shape[0], S, Xp, Yp, Zp,
            masks.shape[-1], PX, PY, PZ, pad, float(cell_size),
            float(compact_support_radius), out.data_ptr(), stream,
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


def bin_occupancy_plain(fx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch slot bytes of the bin rasters: fractions (8, ...) in,
    uint8 (...) out, bit k set iff fx[k, ...] < 1e14 (slot k occupied)."""
    shift = torch.arange(fx.shape[0], device=fx.device).reshape((-1,) + (1,) * (fx.dim() - 1))
    bits = torch.bitwise_left_shift(_occupied(fx, True).to(torch.int32), shift)
    return bits.sum(0).to(torch.uint8)


def bin_occupancy_cuda(fx: torch.Tensor) -> torch.Tensor:
    """The slot byte of every bin of the (8, LX+2, Yp, Zp) fraction raster
    ``fx``: the pre-pass kernel of K2 on a CUDA tensor, the plain version on
    a CPU one. Returns uint8 (LX+2, Yp, Zp) as ``bin_occupancy_plain``."""
    _check_inputs((fx,), "bin_occupancy")
    if fx.shape[0] != 8:
        raise ValueError(f"bin_occupancy: {fx.shape[0]} slots (want 8)")
    if fx.device.type == "cpu":
        return bin_occupancy_plain(fx)
    if fx.device.type != "cuda":
        raise ValueError(f"bin_occupancy: unsupported device {fx.device}")
    lib = load_kernels()
    out = torch.empty(fx.shape[1:], dtype=torch.uint8, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "bin_occupancy_" + _suffix(fx.dtype)),
            fx.data_ptr(), out.numel(), out.data_ptr(), stream,
        )
    bin_occupancy_cuda.launches += 1
    return out


bin_occupancy_cuda.launches = 0


def density_sweep_cuda(fx, fy, fz, LX, bin_size, compact_support_radius):
    """Per-(slot, bin) SPH density sums from the (8, LX+2, Yp, Zp) bin
    rasters: kernel K2 (after its slot-byte pre-pass ``bin_occupancy_cuda``)
    on CUDA tensors, the plain version on CPU tensors. Returns (8, LX,
    (Yp - 2) * Zp) sums of the normalized kernel W; the kernel writes 0 on
    empty query slots, where the plain version may leave NaN."""
    _check_inputs((fx, fy, fz), "density_sweep")
    if fx.device.type == "cpu":
        return density_sweep_plain(fx, fy, fz, LX, bin_size, compact_support_radius)
    if fx.device.type != "cuda":
        raise ValueError(f"density_sweep: unsupported device {fx.device}")
    slots, Xp, Yp, Zp = fx.shape
    if slots != 8 or Xp != LX + 2:
        raise ValueError(f"density_sweep: rasters {tuple(fx.shape)} for LX={LX}")
    lib = load_kernels()
    occ = bin_occupancy_cuda(fx)
    out = torch.empty((slots, LX, (Yp - 2) * Zp), dtype=fx.dtype, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "density_sweep_" + _suffix(fx.dtype)),
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), occ.data_ptr(), LX, Yp, Zp,
            float(bin_size), float(compact_support_radius),
            support_cut2(compact_support_radius, fx.dtype), out.data_ptr(), stream,
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
    runs = _runs_on(hsc, pad, float(compact_support_radius) / float(cell_size), rx.device)
    masks = occupancy_masks_cuda(rv)
    out = torch.empty((C, P, P, P), dtype=rx.dtype, device=rx.device)
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "splat_sweep_" + _suffix(rx.dtype)),
            rx.data_ptr(), ry.data_ptr(), rz.data_ptr(), rv.data_ptr(),
            masks.data_ptr(), runs.data_ptr(), runs.shape[0], S, C, Rp,
            masks.shape[-1], P, pad, float(cell_size),
            float(compact_support_radius), out.data_ptr(), stream,
        )
    splat_sweep_cuda.launches += 1
    return out


splat_sweep_cuda.launches = 0


# ---------------------------------------------------------------------------
# K4: pair sweep over the level-set cell rasters (cell-raster densities)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def pair_cell_offsets(reach: int, h_over_cs: float):
    """Cell-to-cell offsets that can contain particle pairs within the
    support radius: per-axis minimum distance max(|o|-1, 0) cells, pruned
    to sum(dmin^2) <= (h/cs)^2 (+ rounding slack). Meshgrid order, as the
    reference's (splat_pallas.py:342)."""
    rng = np.arange(-reach, reach + 1, dtype=np.int32)
    oi, oj, ok = np.meshgrid(rng, rng, rng, indexing="ij")
    offs = np.stack([oi, oj, ok], axis=-1).reshape(-1, 3)
    d = np.maximum(np.abs(offs) - 1, 0).astype(np.float64)
    keep = (d**2).sum(axis=1) <= (h_over_cs * (1.0 + 1e-3)) ** 2
    return tuple(map(tuple, offs[keep]))


def pair_runs(reach: int, h_over_cs: float) -> np.ndarray:
    """K4's run table: the fan ``pair_cell_offsets`` as unshifted runs
    (o0, o1, o2_lo, o2_hi), each at most 2 reach + 1 long, in its order."""
    return _runs(np.asarray(pair_cell_offsets(reach, h_over_cs), np.int32))


@functools.lru_cache(maxsize=16)
def _pair_runs_on(reach: int, h_over_cs: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pair_runs(reach, h_over_cs), device=device)


# K4's tile (csrc/pair_sweep.cu kTileX, kTileY, 32 z) and the mask words it
# stages per window row (pair_window_words); the library reports its own
# through kernel_geometry
PAIR_TILE = (4, 8, 32)


def pair_window_words(reach: int) -> int:
    return ((62 + 2 * reach) >> 5) + 2


def _check_pair_args(fx, reach, pad, n_cells):
    S, Xp, Yp, Zp = fx.shape
    if reach > pad:
        raise ValueError(f"pair_sweep: reach {reach} beyond the raster pad {pad}")
    if any(p < n + 2 * pad for p, n in zip((Xp, Yp, Zp), n_cells)):
        raise ValueError(f"pair_sweep: rasters {tuple(fx.shape)} too small for {n_cells}, pad {pad}")


def pair_sweep_plain(fx, fy, fz, cs, h, reach, h_over_cs, pad, n_cells):
    """Plain PyTorch pair sweep: ``global_sweep._pair_sweep_xla`` of the
    reference, summed in its order (fan offsets, then source slots). Rasters
    (S, Xp, Yp, Zp) in; acc (S, ncx, ncy, ncz) of unnormalized spline pair
    sums out. Empty query slots hold NaN (f32) or a meaningless finite sum
    (f64), as in the reference; callers read occupied slots only."""
    _check_pair_args(fx, reach, pad, n_cells)
    t = kernels.np_dtype(fx.dtype).type
    two_over_h = float(t(2.0) / t(h))
    ncx, ncy, ncz = (int(v) for v in n_cells)
    S = fx.shape[0]
    sl_q = (slice(None), slice(pad, pad + ncx), slice(pad, pad + ncy), slice(pad, pad + ncz))
    fq = [f[sl_q] for f in (fx, fy, fz)]
    acc = torch.zeros((S, ncx, ncy, ncz), dtype=fx.dtype, device=fx.device)
    for o in pair_cell_offsets(reach, float(h_over_cs)):
        sl = (slice(None),) + tuple(
            slice(pad + int(a), pad + int(a) + n) for a, n in zip(o, (ncx, ncy, ncz))
        )
        # per-axis offset o * cs, formed in the rasters' precision
        od = [float(t(a) * t(cs)) for a in o]
        win = [f[sl] for f in (fx, fy, fz)]
        for kj in range(S):
            dx = fq[0] - (win[0][kj] + od[0])
            dy = fq[1] - (win[1][kj] + od[1])
            dz = fq[2] - (win[2][kj] + od[2])
            d2 = dx * dx + dy * dy + dz * dz
            q = torch.sqrt(d2) * two_over_h
            a = torch.clamp_min(2.0 - q, 0.0)
            b = torch.clamp_min(1.0 - q, 0.0)
            acc += a * a * a - 4.0 * (b * b * b)
    return acc / (4.0 * np.pi)


def pair_sweep_cuda(fx, fy, fz, cs, h, reach, h_over_cs, pad, n_cells):
    """Per-(slot, cell) unnormalized spline pair sums (S, ncx, ncy, ncz)
    from the (S, Xp, Yp, Zp) fraction rasters of ``rasterize_global``:
    kernel K4 (after the occupancy masks of ``fx``, ``occupancy_masks_cuda``
    with ``fractions``) on CUDA tensors, 0 on empty query slots; the plain
    version on CPU tensors."""
    _check_inputs((fx, fy, fz), "pair_sweep")
    if fx.device.type == "cpu":
        return pair_sweep_plain(fx, fy, fz, cs, h, reach, h_over_cs, pad, n_cells)
    if fx.device.type != "cuda":
        raise ValueError(f"pair_sweep: unsupported device {fx.device}")
    _check_pair_args(fx, reach, pad, n_cells)
    S, Xp, Yp, Zp = fx.shape
    ncx, ncy, ncz = (int(v) for v in n_cells)
    t = kernels.np_dtype(fx.dtype).type
    lib = load_kernels()
    runs = _pair_runs_on(reach, float(h_over_cs), fx.device)
    masks = occupancy_masks_cuda(fx, fractions=True)
    out = torch.empty((S, ncx, ncy, ncz), dtype=fx.dtype, device=fx.device)
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(
            getattr(lib, "pair_sweep_" + _suffix(fx.dtype)),
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), masks.data_ptr(),
            runs.data_ptr(), runs.shape[0], S, reach, Xp, Yp, Zp, masks.shape[-1],
            ncx, ncy, ncz, pad, float(cs), float(t(2.0) / t(h)),
            support_cut2(h, fx.dtype), out.data_ptr(), stream,
        )
    pair_sweep_cuda.launches += 1
    return out


pair_sweep_cuda.launches = 0
