"""End-to-end reconstruction benchmark of the port, on one card.

    python -m splashsurf_tpu_torch.bench                  # 2M dam break, 3 warm frames
    python -m splashsurf_tpu_torch.bench --frames 6       # reconstruct_sequence, frames/s
    python -m splashsurf_tpu_torch.bench --sparse         # the 8M canyon (slab route)
    python -m splashsurf_tpu_torch.bench --stage density  # one stage alone: density,
                                                          # aabb, normals or mc
    python -m splashsurf_tpu_torch.bench --device cpu --n 20000 --repeats 1

The counterpart of the JAX package's ``bench.py``, with its scenes, flags
and metrics: a jittered-lattice dam break (or, with ``--sparse``, the
canyon sheet) at the reference's headline parameters (r = 0.011, support
4r, cube 1.5r, iso 0.6), reconstructed with ``reconstruct_surface``.
Frames are uploaded before the timed region, one jittered frame per
repeat; each timed frame ends in ``torch.cuda.synchronize()`` with the mesh
on the host. The warm-up frame is reported apart: it builds the kernels
and plans the frame (and, with ``SPLASHSURF_TPU_MONO_FRAME=1``, captures
the warm frame's graph). Outside the timed region the last mesh must be
non-empty, closed and manifold.

Stdout gets one JSON line, ``{"metric", "value", "unit", "vs_baseline"}``,
with ``value`` = particles / the best frame's seconds. Stderr gets the
card's name and power limit, the route, the switches that change the
frame's path, the median and every frame's seconds, the peak device memory
and ``mesh_summary`` of the last frame, which ``tests/goldens/
torch_fullwidth.json`` holds for the JAX package's meshes of the same
positions. ``main`` also returns what it printed, with the summary.

Runs on CUDA unless ``--device cpu`` is given; without CUDA it raises.
Imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_MPPS = 13_353_401 / 2.467 / 1e6  # 5.413 Mparticles/s (the reference CLI, M4 Pro)
RADIUS = 0.011
# the switches that change a dense frame's path, with their defaults
PATH_SWITCHES = {"SPLASHSURF_TPU_MONO_FRAME": "0", "SPLASHSURF_TPU_PULL": "packed",
                 "SPLASHSURF_TPU_DENSITY_CELLRASTER": "0"}
# the jitter step of the frames, in particle radii: frame k is pts + 1e-5 r k
JITTER = 1e-5
SEQUENCE_JITTER0 = 7  # the first --frames frame's k


def make_dam_break(n_target: int, radius: float, seed: int = 0) -> np.ndarray:
    """Jittered-lattice fluid block with ~8:3:2 aspect (dam-break-like)."""
    rng = np.random.default_rng(seed)
    spacing = 2.0 * radius
    base = (n_target / (8 * 3 * 2)) ** (1.0 / 3.0)
    nx, ny, nz = int(8 * base), int(3 * base), int(2 * base)

    def coords(n):
        return (np.arange(n) + 0.5) * spacing

    X, Y, Z = np.meshgrid(coords(nx), coords(ny), coords(nz), indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    pts += (rng.uniform(-0.25, 0.25, pts.shape) * spacing).astype(np.float32)
    return pts


def make_canyon(n_target: int, radius: float, seed: int = 0, layers: int = 8) -> np.ndarray:
    """Sparse fluid: a thin terrain-following sheet of ``layers`` particle
    layers over a large horizontal extent, the shape of the reference's
    canyon headline run. Its grid is far past the dense gate."""
    rng = np.random.default_rng(seed)
    spacing = 2.0 * radius
    base = (n_target / (4 * layers)) ** 0.5
    nx, nz = int(4 * base), int(base)
    x = (np.arange(nx) + 0.5) * spacing
    z = (np.arange(nz) + 0.5) * spacing
    X, Z = np.meshgrid(x, z, indexing="ij")
    # rolling terrain: two incommensurate waves, amplitude >> sheet depth
    H = 0.9 * (np.sin(X * 1.7) * np.cos(Z * 2.3) + 0.6 * np.sin(X * 0.4 + Z))
    pts = np.empty((nx * nz * layers, 3), np.float32)
    k = 0
    for layer in range(layers):
        Y = H + (layer + 0.5) * spacing
        sl = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
        pts[k : k + nx * nz] = sl
        k += nx * nz
    pts += (rng.uniform(-0.25, 0.25, pts.shape) * spacing).astype(np.float32)
    return pts


def jittered(pts: np.ndarray, radius: float, k: int) -> np.ndarray:
    """Frame k of a run: every position moved by 1e-5 r k (frame 0 is ``pts``)."""
    return pts + np.float32(JITTER * radius * k)


def _deposit(points: np.ndarray, weights: np.ndarray, lo, ext, blocks: int) -> np.ndarray:
    """``weights`` deposited cloud-in-cell onto the centres of the blocks^3
    blocks of the box [lo, lo + ext]: each point splits its weight
    trilinearly between the 8 nearest block centres (all of it to the edge
    blocks beyond the outer centres). The sums are continuous in the points,
    so moving a point by d changes a block's sum by at most d blocks / ext
    of its weight: a point near a block face cannot flip a whole weight."""
    u = (points - lo) / ext * blocks - 0.5
    i0 = np.clip(np.floor(u), 0, blocks - 2).astype(np.int64)
    f = np.clip(u - i0, 0.0, 1.0)
    out = np.zeros(blocks**3)
    for corner in itertools.product((0, 1), repeat=3):
        w = weights
        flat = np.zeros(len(points), np.int64)
        for d in range(3):
            w = w * (f[:, d] if corner[d] else 1.0 - f[:, d])
            flat = flat * blocks + i0[:, d] + corner[d]
        out += np.bincount(flat, weights=w, minlength=blocks**3)
    return out


def mesh_summary(mesh, blocks: int = 4) -> dict:
    """A mesh's summary in f64: its counts, area, divergence-theorem volume
    and bounding box (the totals of ``tests/test_dataset_matrix.py``), and
    the area and the vertices in each of the blocks^3 blocks of the bounding
    box (``_deposit``; triangles by their centroid), x-major, so that a local
    fault shows even where the totals balance out."""
    if blocks < 2:
        raise ValueError(f"blocks must be at least 2, got {blocks}")
    v = np.asarray(mesh.vertices, np.float64)
    t = np.asarray(mesh.triangles)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    cross = np.cross(b - a, c - a)
    norms = np.linalg.norm(cross, axis=1)
    area = 0.5 * float(norms.sum())
    # divergence-theorem volume; meshes are closed so this is exact
    volume = float(np.einsum("ij,ij->i", a, cross).sum() / 6.0)
    lo, hi = v.min(axis=0), v.max(axis=0)
    ext = np.maximum(hi - lo, np.finfo(np.float64).tiny)
    centroids = (a + b + c) / 3.0
    return {
        "num_vertices": int(mesh.num_vertices),
        "num_triangles": int(mesh.num_triangles),
        "area": area,
        "volume": volume,
        "bbox_min": [float(x) for x in lo],
        "bbox_max": [float(x) for x in hi],
        "blocks": blocks,
        "block_area": [float(x) for x in _deposit(centroids, 0.5 * norms, lo, ext, blocks)],
        "block_vertices": [float(x) for x in _deposit(v, np.ones(len(v)), lo, ext, blocks)],
    }


# The bars a mesh summary is held to against the JAX package's: "counts" the
# relative bar of the vertex and triangle counts (0: equal), "total" of the
# area and the volume, "bbox" the absolute bar of the bounding box, "block"
# the relative bar of each block's area and vertices (relative to the block's
# value or the mean block's, whichever is larger). f64 holds the repo's
# golden bar (tests/test_dataset_matrix.py); f32 the counts of the dense
# route equal and the vertices' bar on the box; the canyon's f32 counts the
# cross-route bar of chip_smoke.py phase 13.
BARS = {
    "float64": {"counts": 0.0, "total": 1e-9, "bbox": 1e-9, "block": 1e-8},
    "float32": {"counts": 0.0, "total": 1e-5, "bbox": 1e-4, "block": 1e-4},
    "float32_canyon": {"counts": 1e-4, "total": 1e-5, "bbox": 1e-4, "block": 1e-4},
}


def summary_gaps(got: dict, want: dict, bar: dict) -> list:
    """The entries of ``got`` outside ``bar`` (a ``BARS`` value) of
    ``want``, each as a line of text; empty where the summaries agree."""
    gaps = []
    for key in ("num_vertices", "num_triangles"):
        if abs(got[key] - want[key]) > bar["counts"] * want[key]:
            gaps.append(f"{key} {got[key]} against {want[key]} (rel bar {bar['counts']})")
    for key in ("area", "volume"):
        if abs(got[key] - want[key]) > bar["total"] * abs(want[key]):
            gaps.append(f"{key} {got[key]!r} against {want[key]!r} (rel bar {bar['total']})")
    for key in ("bbox_min", "bbox_max"):
        d = float(np.abs(np.subtract(got[key], want[key])).max())
        if d > bar["bbox"]:
            gaps.append(f"{key} {got[key]} against {want[key]}: {d:.3e} (abs bar {bar['bbox']})")
    if got["blocks"] != want["blocks"]:
        return gaps + [f"blocks {got['blocks']} against {want['blocks']}"]
    for key in ("block_area", "block_vertices"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        scale = np.maximum(np.abs(w), np.abs(w).mean())
        rel = np.abs(g - w) / scale
        if (rel > bar["block"]).any():
            i = int(rel.argmax())
            gaps.append(f"{key}[{i}] {g[i]!r} against {w[i]!r}: {rel[i]:.3e} "
                        f"({int((rel > bar['block']).sum())} blocks past the rel bar "
                        f"{bar['block']})")
    return gaps


def card_identity(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the benchmark runs on the card by default; "
                               "pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def frame_route(positions: torch.Tensor, params) -> tuple:
    """(route, grid) that ``reconstruct_surface`` takes for these positions:
    "dense", "slab" or "subdomain" on the bucketed grid."""
    from splashsurf_tpu_torch.parallel.mesh import devices
    from splashsurf_tpu_torch.reconstruction import (
        _bucket_grid, choose_route, grid_for_reconstruction,
    )

    grid = _bucket_grid(grid_for_reconstruction(
        positions, params.particle_radius, params.compact_support_radius, params.cube_size))
    return choose_route(params, grid, len(devices(positions.device.type))), grid


def _timed(fn, dev: torch.device, repeats: int) -> list:
    """Seconds of ``repeats`` calls of ``fn``, each ending in a synchronise."""
    times = []
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def bench_stage(stage: str, n: int, repeats: int, dev: torch.device) -> dict:
    """Micro-benchmark of one stage on the dam break: the densities (kernel
    K2 on the card), the particles' AABB, the vertex normals of the
    reconstructed mesh, or marching cubes alone on the dense level set
    (rasterized, then K1), at the reference's 5/4 vertex and triangle
    capacities. Prints ``{"metric": "stage_<stage>", ...}``."""
    import splashsurf_tpu_torch as pt
    from splashsurf_tpu_torch import neighbors

    pts = torch.as_tensor(make_dam_break(n, RADIUS), device=dev)
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    h = params.compact_support_radius
    if stage == "density":
        def f():
            return neighbors.compute_particle_densities(pts, h, params.particle_rest_mass)
        unit, scale = "Mparticles/s", n / 1e6
    elif stage == "aabb":
        from splashsurf_tpu_torch.aabb import aabb_from_points

        def f():
            return aabb_from_points(pts)
        unit, scale = "Mparticles/s", n / 1e6
    elif stage == "normals":
        from splashsurf_tpu_torch.mesh import vertex_normals

        rec = pt.reconstruct_surface(pts, params)
        v = torch.as_tensor(rec.mesh.vertices, device=dev)
        t = torch.as_tensor(rec.mesh.triangles, device=dev).long()

        def f():
            return vertex_normals(v, t)
        unit, scale = "Mtris/s", len(rec.mesh.triangles) / 1e6
    elif stage == "mc":
        from splashsurf_tpu_torch import plans
        from splashsurf_tpu_torch.mc.dense import _mc_counts
        from splashsurf_tpu_torch.ops import global_sweep as gs
        from splashsurf_tpu_torch.uniform_grid import kernel_extents

        grid = pt.grid_for_reconstruction(pts, RADIUS, h, params.cube_size)
        hsc = kernel_extents(h, grid.cell_size).half_supported_cells
        rho = neighbors.compute_particle_densities(pts, h, params.particle_rest_mass)
        values = params.particle_rest_mass / rho
        cap = plans.default_overflow_capacity(n)
        rasters, overflow, n_over = gs.rasterize_global(pts, values, grid, 2, hsc, cap)
        if int(n_over) > cap:
            raise RuntimeError(f"{int(n_over)} overflow particles past the capacity {cap}")
        ls = gs.sweep_global(rasters, overflow, grid, h, hsc)
        iso = params.iso_surface_threshold
        nv, nt = _mc_counts(ls, iso)
        vcap, tcap = plans.mc_caps(nv, nt)

        def f():
            return gs.mc_global_packed(ls, grid, iso, vcap, tcap)
        unit, scale = "Mcells/s", grid.total_cells / 1e6
    else:
        raise SystemExit(f"unknown stage {stage}")

    f()
    times = _timed(f, dev, repeats)
    best = min(times)
    line = {"metric": f"stage_{stage}", "value": round(scale / best, 3), "unit": unit,
            "vs_baseline": 0.0}
    _err(f"# stage {stage}: seconds {times} ({card_identity(dev)})")
    print(json.dumps(line), flush=True)
    return {"line": line, "times": times}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m splashsurf_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[1])
    ap.add_argument("--n", type=int, default=2_000_000, help="particle count")
    ap.add_argument("--smoke", action="store_true", help="small fast run")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile", action="store_true", help="print stage timings")
    ap.add_argument("--stage", default=None, choices=["density", "aabb", "normals", "mc"],
                    help="micro-benchmark one stage instead of the full frame")
    ap.add_argument("--frames", type=int, default=0,
                    help="sequence mode: reconstruct N jittered frames back to back "
                    "and report frames/s")
    ap.add_argument("--sparse", action="store_true",
                    help="canyon-like sparse sheet over a huge grid, past the dense gate "
                    "(the slab route on one device)")
    ap.add_argument("--layers", type=int, default=8,
                    help="sheet thickness of the --sparse canyon in particle layers")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu only when asked)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                    help="the reconstruction's precision")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark of ``argv`` (default ``sys.argv[1:]``): prints its
    JSON line and returns {"line": the JSON object, ...} with, for a
    frame run, "route", "n", "warmup_s", "times", "peak_bytes" and
    "summary" (``mesh_summary`` of the last timed frame, or of frame 0 of
    ``--frames``)."""
    args = parse_args(argv)
    dev = _device(args.device)
    if args.stage:
        return bench_stage(args.stage, args.n, args.repeats, dev)
    if args.smoke:
        args.n = min(args.n, 100_000)
        args.repeats = 1

    import splashsurf_tpu_torch as pt
    from splashsurf_tpu_torch import profiling

    ident = card_identity(dev)
    if args.sparse:
        if args.n == 2_000_000 and not args.smoke:
            args.n = 8_000_000  # default sparse scale
        pts = make_canyon(args.n, RADIUS, layers=args.layers)
    else:
        pts = make_dam_break(args.n, RADIUS)
    n = len(pts)
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5, dtype=args.dtype)
    dtype = params.torch_dtype

    def upload(k):
        return torch.as_tensor(jittered(pts, RADIUS, k), device=dev).to(dtype)

    base = upload(0)
    route, grid = frame_route(base, params)
    switches = {k: os.environ.get(k, v) for k, v in PATH_SWITCHES.items()}
    _err(f"# device: {dev} ({ident}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    _err(f"# particles: {n}; {args.dtype}; grid {grid.n_cells[0]}x{grid.n_cells[1]}x"
         f"{grid.n_cells[2]} = {grid.total_cells / 1e6:.1f}M cells; route {route}; "
         f"switches {switches}")
    frames = [] if args.frames else [upload(rep + 1) for rep in range(args.repeats)]
    _sync(dev)

    # warm-up: builds the kernels and plans the frame (and captures the mono
    # frame's graph where it is switched on)
    t0 = time.perf_counter()
    rec = pt.reconstruct_surface(base, params)
    _sync(dev)
    warm = time.perf_counter() - t0
    _err(f"# warmup (kernel build included): {warm:.3f} s; mesh: {rec.mesh.num_vertices} "
         f"verts / {rec.mesh.num_triangles} tris")
    if route != "dense":
        from splashsurf_tpu_torch import subdomains
        from splashsurf_tpu_torch.ops import slab_sweep

        run = slab_sweep.LAST_RUN if route == "slab" else subdomains.LAST_RUN
        _err(f"# {route} run: " + str({k: v for k, v in run.items() if k != "rows"}))
    out = {"route": route, "n": n, "warmup_s": warm}

    if args.frames:
        # sequence mode: frame t + 1 is dispatched before frame t's mesh is
        # resolved, so its copy overlaps the next frame's work
        seq = [upload(k + SEQUENCE_JITTER0) for k in range(args.frames)]
        _sync(dev)
        meshes = []
        t0 = time.perf_counter()
        for rec in pt.reconstruct_sequence(seq, params):
            if rec.mesh.num_triangles <= 0:
                raise AssertionError("a sequence frame has an empty mesh")
            meshes.append(rec.mesh)
        _sync(dev)
        dt = time.perf_counter() - t0
        _check_mesh(pt, meshes[0])
        _check_mesh(pt, meshes[-1])
        out["summary"] = mesh_summary(meshes[0])
        _err(f"# {args.frames} frames in {dt:.4f} s; mesh summary of frame 0: "
             + json.dumps(out["summary"]))
        out["line"] = {
            "metric": "sequence_frames_per_second",
            "value": round(args.frames / dt, 3),
            "unit": "frames/s",
            "vs_baseline": round((args.frames / dt) / (13_353_401 / 2.467 / n), 3),
        }
        out["times"] = [dt]
        print(json.dumps(out["line"]), flush=True)
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for frame in frames:
        if args.profile:
            profiling.reset()
        _sync(dev)
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(frame, params)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        if args.profile:
            _err(f"# frame {times[-1]:.4f} s")
            _err(profiling.write_to_string())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    _check_mesh(pt, rec.mesh)
    best, med = min(times), statistics.median(times)
    mpps = n / best / 1e6
    out.update(times=times, peak_bytes=peak, summary=mesh_summary(rec.mesh))
    _err(f"# frame times: {times}")
    _err(f"# median {med:.4f} s ({n / med / 1e6:.3f} Mparticles/s), best {best:.4f} s; "
         f"peak device memory {peak} B ({ident})")
    _err("# mesh summary of the last frame: " + json.dumps(out["summary"]))
    out["line"] = {
        "metric": ("sparse_subdomain_reconstruction_throughput" if args.sparse
                   else "end_to_end_reconstruction_throughput"),
        "value": round(mpps, 3),
        "unit": "Mparticles/s",
        "vs_baseline": round(mpps / BASELINE_MPPS, 3),
    }
    print(json.dumps(out["line"]), flush=True)
    return out


def _check_mesh(pt, mesh) -> None:
    """A non-empty, closed and manifold mesh, or AssertionError."""
    if mesh.num_vertices == 0 or mesh.num_triangles == 0:
        raise AssertionError("empty mesh")
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None:
        raise AssertionError(f"mesh not closed or not manifold: {bad}")


if __name__ == "__main__":
    main()
