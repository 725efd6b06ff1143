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
     from a CUDA input (kernels): equal counts, vertices within 1e-4.

The line before the last is a JSON object of the kernels' launches, errors
and times; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device the script exits non-zero before printing any result.
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
F32_TOL = dict(rtol=2e-5, atol=1e-5)  # the reference's kernel-vs-scan bar
F64_TOL = dict(rtol=1e-10, atol=1e-12)


def log(msg):
    print(msg, flush=True)


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


def compare(name, got, want, tol, mask=None):
    if mask is not None:
        got, want = got[mask], want[mask]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(got, want, **tol)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    log(f"  {name}: max_abs_err {err:.3e} over {got.numel()} values ({tol})")
    return err


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
    err1 = compare("K1 f32", k1(), p1(), F32_TOL)
    ms1, pms1 = cuda_ms(k1, 10), cuda_ms(p1, 3)
    log(f"  K1 f32: kernel {ms1:.3f} ms, plain {pms1:.3f} ms")
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
        max_abs_err=err1, ms=ms1, plain_ms=pms1,
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
    err2 = compare("K2 f32", k2(), p2(), F32_TOL, occupied(drast))
    ms2, pms2 = cuda_ms(k2, 10), cuda_ms(p2, 3)
    log(f"  K2 f32: kernel {ms2:.3f} ms, plain {pms2:.3f} ms")
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
        max_abs_err=err2, ms=ms2, plain_ms=pms2,
    )

    # --- 4. the main path at full size ---------------------------------------
    log(f"phase 4: reconstruct_surface, {n_main} particles")
    sk.sweep_global_cuda.launches = 0
    sk.density_sweep_cuda.launches = 0
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

    print(ident, flush=True)
    print(json.dumps({"kernels": [kernels["sweep_global"], kernels["density_sweep"]]}),
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
