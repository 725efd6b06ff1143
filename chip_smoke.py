#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``splashsurf_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (each prints progress; any failure raises and exits non-zero):
  0. the card: its name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from ``splashsurf_tpu_torch/csrc``;
  2. kernel K1 (level-set sweep) against its plain PyTorch version on the
     rasters of the 2M-particle dam break, f32 and (small) f64, timed;
  3. kernel K2 (density sweep) the same way, plus a lattice wider than 5376
     lanes;
  4. ``reconstruct_surface`` on the 2M-particle dam break (r = 0.011,
     support 4r, cube 1.5r, iso 0.6): one cold frame and three more; the mesh
     must be closed and manifold and both kernels must have launched;
  5. the same scene at ~100K particles from a CPU input (plain versions) and
     from a CUDA input (kernels): equal counts, vertices within 1e-4;
  6. kernel K3 (per-subdomain sweep) against its plain version on the
     rasters of one splat chunk of the 8M canyon sheet, f32, and on a small
     f64 chunk, timed;
  7. ``reconstruct_surface`` on the 8M canyon (r = 0.011, support 4r, cube
     1.5r, 64-cell subdomains, decomposition forced): one cold frame and two
     warm ones, with the route's stage seconds; the mesh must be closed, the
     subdomain route taken with binned densities, and K3 launched;
  8. the subdomain route on a ~100K canyon from a CPU input against a CUDA
     input, and on the 100K dam break against the dense route on the card:
     equal counts, vertices within 1e-4.

Each kernel's line carries its bound: the larger of the bytes it must move
(rasters read once, output written once) over 3.35 TB/s and the float
operations of the occupied terms this run's data needs over 67 TFLOP/s (an
H100 SXM's data-sheet peaks at 700 W; the card's power limit is printed
beside). No single PyTorch call computes these functions, so
``library_ms`` is null.

The line before the last is a JSON object of the kernels' launches, errors,
times and bounds; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RADIUS = 0.011
N_MAIN = 2_000_000
N_CROSS = 100_000
N_CANYON = 8_000_000
F32_TOL = dict(rtol=2e-5, atol=1e-5)  # the reference's kernel-vs-scan bar
K3_F32_TOL = dict(rtol=1e-5, atol=2e-5)  # the reference's splat bar
F64_TOL = dict(rtol=1e-10, atol=1e-12)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# float operations of one occupied term, counted in the kernels' loops
# (sqrt and max count one each): K1/K3 23 (offset adds 4, d2 5, q 2, the
# two clamped cubes 8, weight and sum 4); K2 22 (differences 3, d2 5, q 2,
# cubes 8, combine and sum 4)
FLOPS_PER_TERM = {"sweep_global": 23, "density_sweep": 22, "splat_sweep": 23}


def log(msg):
    print(msg, flush=True)


def reset_launches(sk):
    """Set every kernel's launch count to 0, just before a main path runs."""
    for fn in (sk.sweep_global_cuda, sk.density_sweep_cuda, sk.splat_sweep_cuda):
        fn.launches = 0


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name, n_bytes, n_terms):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the occupied terms' operations over the float32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_terms * FLOPS_PER_TERM[name] / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sweep_terms(fv, hsc, pad, n_points):
    """Occupied (point, offset, slot) terms of a level-set sweep (K1, K3):
    for every offset of the fan, the non-empty raster entries in its window
    of the points."""
    from splashsurf_tpu_torch.density import gather_cell_offsets

    total = 0
    for o in gather_cell_offsets(hsc) + pad:
        sl = (...,) + tuple(slice(int(a), int(a) + n) for a, n in zip(o, n_points))
        total += int(torch.count_nonzero(fv[sl]))
    return total


def density_terms(fx):
    """Occupied (query, source) pairs of the 27-bin density sweep (K2):
    for every bin, its occupied slots times those of each neighbour bin."""
    occ = (fx < 1e14).sum(dim=0).to(torch.float64)  # (LX+2, Yp, Zp)
    X, Y, Z = occ.shape
    q = occ[1 : X - 1, 1 : Y - 1, 1 : Z - 1]
    total = 0.0
    for a in range(3):
        for b in range(3):
            for c in range(3):
                total += float((q * occ[a : a + X - 2, b : b + Y - 2, c : c + Z - 2]).sum())
    return int(total)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, got, want, tol, mask=None):
    if mask is not None:
        got, want = got[mask], want[mask]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(got, want, **tol)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    log(f"  {name}: max_abs_err {err:.3e} over {got.numel()} values ({tol})")
    return err


def canyon_params(pt):
    """The canyon parameters: r = 0.011, support 4r, cube 1.5r, iso 0.6, and
    the decomposition forced into 64-cell subdomains."""
    return pt.Parameters.new_relative(
        RADIUS, 4.0, 1.5,
        grid_decomposition=pt.GridDecompositionParameters(64, auto_disable=False),
    )


def k3_chunk(pt, pts, params, last_chunk=True):
    """The rasters of one splat chunk of ``pts`` as the subdomain route
    builds them: the fullest chunk of the route's own plan, or with
    ``last_chunk`` False every occupied subdomain in one chunk."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import subdomains as S
    from splashsurf_tpu_torch.reconstruction import _bucket_grid

    h = params.compact_support_radius
    grid = _bucket_grid(pt.grid_for_reconstruction(pts, RADIUS, h, params.cube_size))
    sd = S.initialize_parameters(params, grid)
    rho = N.compute_particle_densities(pts, h, params.particle_rest_mass)
    values = params.particle_rest_mass / rho
    targets, pids, cells, ranks = S.decompose(pts, sd)
    _, starts, counts = S.occupied_segments(targets)
    plan = S.splat_plan(counts, sd, pts.element_size(), S.CHUNK_BYTES)
    rows_np = plan[-1] if last_chunk else np.arange(len(counts))
    rows = torch.as_tensor(rows_np, device=pts.device)
    idx, row = S._gather_pairs(
        torch.as_tensor(starts, device=pts.device), torch.as_tensor(counts, device=pts.device),
        rows, int(counts[rows_np].sum()),
    )
    rasters = S.chunk_rasters(pts, values, pids[idx], row, cells[idx], ranks[idx], len(rows_np), sd)
    return rasters, sd, len(counts), len(plan)


def phase_k3(pt, dev, canyon, kernels):
    """Phase 6: K3 against its plain version on a chunk of the 8M canyon
    (f32, timed) and on a small f64 canyon chunk."""
    import bench
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    params = canyon_params(pt)
    h = params.compact_support_radius
    rasters, sd, B, n_chunks = k3_chunk(pt, canyon, params)
    hsc, m, P = sd.margin_cells, sd.margin_cells, sd.points_per_dim
    cs = sd.global_grid.cell_size
    log(f"phase 6: K3 on the fullest of {n_chunks} splat chunks ({B} subdomains), "
        f"rasters {tuple(rasters[0].shape)}")
    k3 = lambda: sk.splat_sweep_cuda(*rasters, cs, h, hsc, m, P)
    p3 = lambda: sk.splat_sweep_plain(*rasters, cs, h, hsc, m, P)
    out3 = k3()
    err3 = compare("K3 f32", out3, p3(), K3_F32_TOL)
    ms3, pms3 = cuda_ms(k3, 5), cuda_ms(p3, 2)
    b3 = bound("splat_sweep", nbytes(*rasters, out3), sweep_terms(rasters[3], hsc, m + 1, (P, P, P)))
    log(f"  K3 f32: kernel {ms3:.3f} ms, plain {pms3:.3f} ms, bound {b3[0]:.4f} ms ({b3[1]})")
    del rasters, out3
    small = torch.as_tensor(bench.make_canyon(20_000, RADIUS, seed=5), device=dev).double()
    r64, sd64, B64, _ = k3_chunk(pt, small, params.try_convert("float64"), last_chunk=False)
    compare(
        f"K3 f64 ({B64} subdomains)",
        sk.splat_sweep_cuda(*r64, cs, h, hsc, m, P),
        sk.splat_sweep_plain(*r64, cs, h, hsc, m, P),
        F64_TOL,
    )
    kernels["splat_sweep"] = dict(
        name="splat_sweep", route="cuda",
        source="splashsurf_tpu_torch/csrc/splat_sweep.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:518",
        max_abs_err=err3, ms=ms3, plain_ms=pms3, bound_ms=b3[0], bound_by=b3[1],
        library_ms=None,
    )


def phase_canyon(pt, canyon, kernels, ident):
    """Phase 7: the subdomain route at full size, the main path of K3."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import subdomains as S
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    params = canyon_params(pt)
    n = canyon.shape[0]
    log(f"phase 7: reconstruct_surface, {n}-particle canyon, 64-cell subdomains")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(sk)
    frame_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(canyon, params)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    launches = sk.splat_sweep_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0:
        raise AssertionError("kernel splat_sweep was not launched by the subdomain route")
    kernels["splat_sweep"]["launches"] = launches
    if rec.subdomain_grid is None:
        raise AssertionError("the canyon did not take the subdomain route")
    if N.LAST_GATE.get("kind") not in ("binned8", "binned"):
        raise AssertionError(f"densities took {N.LAST_GATE.get('kind')}, not a binned formulation")
    mesh = rec.mesh
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None:
        raise AssertionError(f"canyon mesh not closed/manifold: {bad}")
    if not np.isfinite(mesh.vertices).all() or mesh.num_triangles == 0:
        raise AssertionError("empty or non-finite canyon mesh")
    run = S.LAST_RUN
    warm = statistics.median(frame_s[1:])
    log(f"  grid {rec.grid.n_cells}, subdomains {run['n_subdomains']}, occupied B {run['B']}, "
        f"pairs {run['n_pairs']}, splat chunks {run['splat_chunks']}; densities "
        f"{N.LAST_GATE['kind']} (lattice {N.LAST_GATE['lattice']}, {N.LAST_GATE['n_bins']} "
        f"occupied bins, max occupancy {N.LAST_GATE['max_occ']})")
    log(f"  resident level sets {run['ls_bytes']} bytes; peak device memory {peak} bytes")
    log(f"  mesh {mesh.num_vertices} vertices, {mesh.num_triangles} triangles, closed")
    log("  stage seconds (last frame): "
        + ", ".join(f"{k} {v:.4f}" for k, v in run["stage_s"].items()))
    log(f"  frame seconds {[round(x, 4) for x in frame_s]}; warm median {warm:.4f} s = "
        f"{n / warm / 1e6:.3f} Mparticles/s ({ident}); K3 launches {launches}")


def phase_cross_subdomain(pt, dev, dam):
    """Phase 8: the subdomain route from a CPU input against a CUDA input,
    and against the dense route on the card."""
    from scipy.spatial import cKDTree

    import bench

    params = canyon_params(pt)
    cross = bench.make_canyon(N_CROSS, RADIUS, seed=3)
    log(f"phase 8: {len(cross)}-particle canyon, subdomain route, CPU input vs CUDA input")
    rc = pt.reconstruct_surface(cross, params, device="cpu")
    rg = pt.reconstruct_surface(torch.as_tensor(cross, device=dev), params)
    check_same_mesh("cpu/cuda canyon", rc.mesh, rg.mesh, ordered=True)
    log(f"  {len(dam)}-particle dam break on the card: subdomain route vs dense route")
    rs = pt.reconstruct_surface(torch.as_tensor(dam, device=dev), params)
    rd = pt.reconstruct_surface(
        torch.as_tensor(dam, device=dev), pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    )
    if rs.subdomain_grid is None or rd.subdomain_grid is not None:
        raise AssertionError("the routes were not the ones asked for")
    check_same_mesh("subdomain/dense dam break", rs.mesh, rd.mesh, ordered=False, tree=cKDTree)


def check_same_mesh(name, a, b, ordered, tree=None):
    """Equal counts and vertices within 1e-4: position by position when both
    lists share an order, else by nearest neighbour both ways."""
    if (a.num_vertices, a.num_triangles) != (b.num_vertices, b.num_triangles):
        raise AssertionError(
            f"{name}: counts differ: {a.num_vertices}/{a.num_triangles} vs "
            f"{b.num_vertices}/{b.num_triangles}"
        )
    if ordered:
        vdiff = float(np.abs(a.vertices - b.vertices).max()) if a.num_vertices else 0.0
    else:
        vdiff = max(float(tree(b.vertices).query(a.vertices)[0].max()),
                    float(tree(a.vertices).query(b.vertices)[0].max()))
    if vdiff >= 1e-4:
        raise AssertionError(f"{name}: vertices differ by {vdiff}")
    same = ordered and bool((a.triangles == b.triangles).all())
    log(f"  {name}: {a.num_vertices} vertices, {a.num_triangles} triangles; max vertex "
        f"diff {vdiff:.3e}" + (f"; triangle lists equal: {same}" if ordered else ""))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ident = card_identity()
    log(f"phase 0: card {ident}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import bench
    import splashsurf_tpu_torch as pt
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.reconstruction import _bucket_grid

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sk.load_kernels()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in (sk.build_kernels().parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())

    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    h = params.compact_support_radius
    pts_np = bench.make_dam_break(N_MAIN, RADIUS)
    n_main = len(pts_np)  # the generator rounds the block to whole rows
    pts = torch.as_tensor(pts_np, device=dev)
    grid = _bucket_grid(pt.grid_for_reconstruction(pts, RADIUS, h, params.cube_size))
    hsc = pt.kernel_extents(h, grid.cell_size).half_supported_cells
    log(f"  scene: {n_main} particles, grid {grid.n_cells} "
        f"({grid.total_cells} cells), hsc {hsc}")
    kernels = {}

    # --- 2. K1 ---------------------------------------------------------------
    rho = N.compute_particle_densities(pts, h, params.particle_rest_mass)
    values = params.particle_rest_mass / rho
    rasters, overflow = gs.rasterize_global(pts, values, grid, 2, hsc)
    log(f"phase 2: K1 on rasters {tuple(rasters[0].shape)}, "
        f"{overflow[0].shape[0]} overflow particles")
    k1 = lambda: sk.sweep_global_cuda(*rasters, grid.cell_size, h, hsc, grid.n_points)
    p1 = lambda: sk.sweep_global_plain(*rasters, grid.cell_size, h, hsc, grid.n_points)
    out1 = k1()
    err1 = compare("K1 f32", out1, p1(), F32_TOL)
    ms1, pms1 = cuda_ms(k1, 10), cuda_ms(p1, 3)
    b1 = bound("sweep_global", nbytes(*rasters, out1),
               sweep_terms(rasters[3], hsc, hsc + 1, grid.n_points))
    log(f"  K1 f32: kernel {ms1:.3f} ms, plain {pms1:.3f} ms, bound {b1[0]:.4f} ms ({b1[1]})")
    small = torch.as_tensor(bench.make_dam_break(20_000, RADIUS), device=dev)
    sgrid = pt.grid_for_reconstruction(small, RADIUS, h, params.cube_size)
    s64 = small.double()
    r64, _ = gs.rasterize_global(s64, torch.full_like(s64[:, 0], 1e-3), sgrid, 2, hsc)
    compare(
        "K1 f64",
        sk.sweep_global_cuda(*r64, sgrid.cell_size, h, hsc, sgrid.n_points),
        sk.sweep_global_plain(*r64, sgrid.cell_size, h, hsc, sgrid.n_points),
        F64_TOL,
    )
    del rasters, r64
    kernels["sweep_global"] = dict(
        name="sweep_global", route="cuda",
        source="splashsurf_tpu_torch/csrc/sweep_global.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:31",
        max_abs_err=err1, ms=ms1, plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
        library_ms=None,
    )

    # --- 3. K2 ---------------------------------------------------------------
    lo, hi = torch.aminmax(pts, dim=0)
    phases = N._octant_phase(pts, h / 2.0)
    agrid = N._phase_aligned_bingrid(lo.cpu().numpy(), hi.cpu().numpy(), h, phases)
    drast, _, ok = N.geoslot_rasters(pts, agrid)
    if not bool(ok):
        raise AssertionError("geoslot octant check failed on the dam break")
    LX = agrid.dims[0]
    log(f"phase 3: K2 on lattice {agrid.dims}, rasters {tuple(drast[0].shape)}")

    def occupied(r):
        S, _, Yp, Zp = r[0].shape
        W = (Yp - 2) * Zp
        q = r[0].reshape(S, -1, Yp * Zp)[:, 1 : 1 + r[0].shape[1] - 2, Zp + 1 : Zp + 1 + W]
        return q < 1e14  # empty query slots hold the far sentinel

    k2 = lambda: sk.density_sweep_cuda(*drast, LX, agrid.bin_size, h)
    p2 = lambda: sk.density_sweep_plain(*drast, LX, agrid.bin_size, h)
    out2 = k2()
    err2 = compare("K2 f32", out2, p2(), F32_TOL, occupied(drast))
    ms2, pms2 = cuda_ms(k2, 10), cuda_ms(p2, 3)
    b2 = bound("density_sweep", nbytes(*drast, out2), density_terms(drast[0]))
    log(f"  K2 f32: kernel {ms2:.3f} ms, plain {pms2:.3f} ms, bound {b2[0]:.4f} ms ({b2[1]})")
    rng = np.random.default_rng(7)
    for dt, LXw, LY, LZ, tol in ((torch.float32, 12, 80, 78, F32_TOL),
                                 (torch.float64, 6, 20, 18, F64_TOL)):
        shape = (8, LXw + 2, LY + 2, LZ + 2)
        fr = rng.uniform(0, h, (3,) + shape)
        fr[:, rng.uniform(size=shape) < 0.5] = np.inf if dt == torch.float32 else 1e15
        fr[:, :, [0, -1]] = fr[:, :, :, [0, -1]] = fr[:, :, :, :, [0, -1]] = (
            np.inf if dt == torch.float32 else 1e15
        )
        wr = [torch.as_tensor(f, dtype=dt, device=dev).contiguous() for f in fr]
        compare(
            f"K2 {dt} lattice {(LXw, LY, LZ)} (W = {LY * (LZ + 2)})",
            sk.density_sweep_cuda(*wr, LXw, h, h),
            sk.density_sweep_plain(*wr, LXw, h, h),
            tol, occupied(wr),
        )
    del drast
    kernels["density_sweep"] = dict(
        name="density_sweep", route="cuda",
        source="splashsurf_tpu_torch/csrc/density_sweep.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:202",
        max_abs_err=err2, ms=ms2, plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
        library_ms=None,
    )

    # --- 4. the main path at full size ---------------------------------------
    log(f"phase 4: reconstruct_surface, {n_main} particles")
    reset_launches(sk)
    frame_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(pts, params)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    launches = {
        "sweep_global": sk.sweep_global_cuda.launches,
        "density_sweep": sk.density_sweep_cuda.launches,
    }
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
        kernels[name]["launches"] = n
    mesh = rec.mesh
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None:
        raise AssertionError(f"mesh not closed/manifold: {bad}")
    if not np.isfinite(mesh.vertices).all() or mesh.num_triangles == 0:
        raise AssertionError("empty or non-finite mesh")
    warm = statistics.median(frame_s[1:])
    log(f"  mesh {mesh.num_vertices} vertices, {mesh.num_triangles} triangles, closed")
    log(f"  frame seconds {[round(s, 4) for s in frame_s]}; warm median {warm:.4f} s "
        f"= {n_main / warm / 1e6:.3f} Mparticles/s ({ident}); launches {launches}")

    # --- 5. cross-check: plain (CPU) vs kernels (CUDA) ------------------------
    cross = bench.make_dam_break(N_CROSS, RADIUS, seed=3)
    log(f"phase 5: cross-check, {len(cross)} particles, CPU input vs CUDA input")
    rc = pt.reconstruct_surface(cross, params, device="cpu")
    rg = pt.reconstruct_surface(torch.as_tensor(cross, device=dev), params)
    if (rc.mesh.num_vertices, rc.mesh.num_triangles) != (
        rg.mesh.num_vertices, rg.mesh.num_triangles
    ):
        raise AssertionError(
            f"counts differ: cpu {rc.mesh.num_vertices}/{rc.mesh.num_triangles}, "
            f"cuda {rg.mesh.num_vertices}/{rg.mesh.num_triangles}"
        )
    vdiff = float(np.abs(rc.mesh.vertices - rg.mesh.vertices).max())
    same_tris = bool((rc.mesh.triangles == rg.mesh.triangles).all())
    if vdiff >= 1e-4:
        raise AssertionError(f"vertices differ by {vdiff}")
    log(f"  {rg.mesh.num_vertices} vertices, {rg.mesh.num_triangles} triangles; "
        f"max vertex diff {vdiff:.3e}; triangle lists equal: {same_tris}")

    # --- 6-8. the subdomain route -------------------------------------------
    canyon = torch.as_tensor(bench.make_canyon(N_CANYON, RADIUS), device=dev)
    phase_k3(pt, dev, canyon, kernels)
    phase_canyon(pt, canyon, kernels, ident)
    del canyon
    phase_cross_subdomain(pt, dev, cross)

    print(ident, flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in ("sweep_global", "density_sweep", "splat_sweep")]}),
          flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
