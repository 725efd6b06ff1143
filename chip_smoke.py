#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``splashsurf_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 18   # phases 0, 1 and 18 alone, no result line
    python3 chip_smoke.py --phase 19   # phases 0, 1 and 19 alone, no result line
    python3 chip_smoke.py --phase 20   # phases 0, 1 and 20 alone, no result line
    python3 chip_smoke.py --phase 21   # phases 0, 1 and 21 alone, no result line
    python3 chip_smoke.py --phase 22   # phases 0, 1 and 22 alone, no result line
    python3 chip_smoke.py --phase 23   # phases 0, 1 and 23 alone, no result line
    python3 chip_smoke.py --phase 24   # phases 0, 1 and 24 alone, no result line
    python3 chip_smoke.py --phase 25   # phases 0, 1 and 25 alone, no result line

Phases (each prints progress; any failure raises and exits non-zero):
  0. the card: its name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from ``splashsurf_tpu_torch/csrc``;
  2. kernel K1 (level-set sweep) against its plain PyTorch version on the
     rasters of the 2M-particle dam break, f32 and (small) f64, timed (the
     time includes the occupancy-mask pre-pass), and on edge rasters (only
     slot 1 occupied, entries on mask-word boundaries, a particle in each
     corner) in both; the pre-pass bit-equal to its plain version; the
     compiler's registers and spills, the shared memory per block and the
     rasters' occupancy as the sweep's tiles see it;
  3. kernel K2 (density sweep) the same way (the time includes its
     slot-byte pre-pass, bit-equal to its plain version), plus a lattice
     wider than 5376 lanes, an f64 lattice and one whose pairs straddle the
     support radius; its compiler report and the lattice's occupancy (query
     fill, occupied pairs and pairs within the support per particle);
  4. ``reconstruct_surface`` on the 2M-particle dam break (r = 0.011,
     support 4r, cube 1.5r, iso 0.6): one cold frame and three more, warm on
     the frame plans; the mesh must be closed and manifold and both kernels
     must have launched; ``SPECULATION_STATS`` of the four frames;
  5. the same scene at ~100K particles from a CPU input (plain versions) and
     from a CUDA input (kernels): equal counts, vertices within 1e-4;
  6. kernel K3 (per-subdomain sweep) against its plain version on the
     rasters of one splat chunk of the 8M canyon sheet, f32, and on a small
     f64 chunk, timed with the pre-pass, and on the edge rasters of phase 2
     (P = 33); masks, compiler report and occupancy as in phase 2;
  7. ``reconstruct_surface`` on the 8M canyon (r = 0.011, support 4r, cube
     1.5r, 64-cell subdomains, decomposition forced): one cold frame and two
     warm ones, with the route's stage seconds; the mesh must be closed, the
     subdomain route taken with binned densities, and K3 launched;
  8. the subdomain route on a ~100K canyon from a CPU input against a CUDA
     input, and on the 100K dam break against the dense route on the card:
     equal counts, vertices within 1e-4;
  9. kernel K4 (pair sweep of the cell-raster densities) against its plain
     version on the meta rasters of the 2M dam break, f32, and of a 20K dam
     break in f64, timed with its mask pre-pass, on occupied query slots (0
     on the empty ones), and on edge rasters in f32 and f64 (only slot 1
     occupied; queries on mask-word and tile boundaries; a query and a
     source in each corner; pairs just inside and just outside the
     support); masks, compiler report, shared memory and occupancy (query
     fill, busy 32-cell segments, pairs per particle, tiles skipping a slot);
 10. ``reconstruct_sequence`` over 6 frames of the 2M dam break with the
     cell-raster densities (``SPLASHSURF_TPU_DENSITY_CELLRASTER=1``), from
     no plan: a frame without raster overflow takes them (K4 launched once,
     K2 not at all) when, at its dispatch, the overflow plan of its grid is
     0 and its MC capacities are planned, as in the reference, and the
     legacy densities (K2 once) otherwise, which is the first frame; one
     mask pre-pass for each K1 and K4 launch; each mesh is closed and equals
     a frame-at-a-time run from no plan, and frame 1 agrees with the legacy
     densities (rho rtol 1e-5, equal counts, vertices within 1e-4);
     per-frame seconds pipelined and frame at a time, and the stage split
     of both density formulations;
 11. the user's command on the 2M dam break, in-process through the CLI
     (``run_splashsurf``): the particles and a seeded velocity written to a
     VTK file, then ``reconstruct`` with cleanup, barnacle decimation,
     weighted smoothing, SPH normals and their smoothing, the velocity
     interpolated and the mesh checked; K1 and K2 must launch, the native
     half-edge engine must load, and the mesh read back must be closed and
     manifold; the profile tree (stage seconds, file IO included), the mesh
     sizes around cleanup and decimation and the peak device memory;
 12. ``reconstruction_pipeline`` on a 60K dam break in f64 with the same
     chain, CPU input against CUDA input (triangle lists equal, vertices and
     attributes within rtol 2e-5 / atol 1e-5: after the cleanup the mesh is
     f32), and the f32 smoothing and SPH-interpolation ops on one host mesh,
     CUDA against CPU at the same tolerance.
 13. the slab route: ``reconstruct_surface`` on the 8M canyon with default
     parameters (past the 160M-cell dense gate: 8 slabs of 340 cells, one
     K1 launch each), a cold frame and three warm ones with the route's
     stage seconds and the peak device memory; the mesh closed, its counts
     within 1e-4 of phase 7's subdomain mesh; the 2M dam break through 7
     slabs (the gate and the slab budget at 1M cells) against phase 4's
     dense mesh (triangle lists equal, vertices within 1e-6); K1 against
     its plain version on 8-cell slab windows, one inside the fluid and the
     ragged last slab of a grid that ends in it;
 14. the neighbour lists (``global_neighborhood_list=True``): the 100K dam
     break from a CPU input against a CUDA input through
     ``reconstruct_surface``, then the 2M dam break's search on the card
     (seconds apart from the host lists' build, peak device memory,
     ``compute_neighborhood_stats``) against the same search on the CPU;
 15. the subdomain route's streamed mode (run after phase 13, while the
     canyon is on the card): one resident frame of the 8M canyon with
     decomposition forced, then one cold and two warm frames with
     ``SPLASHSURF_TPU_STREAM=1``, with both modes' stage seconds and device
     memory peaks per stage, the shell table's bytes, the chunks (K3
     launches) and the raster overflow count; the streamed mesh closed, K3
     launched once per chunk, and the mesh equal to phase 7's resident mesh
     (bit for bit where no sum ran with atomics: the splat's overflow
     scatter and the binned densities' overflow correction use them;
     otherwise equal triangle lists and vertices within 1e-6); then the
     auto gate on the 100K canyon of phase 8: with the switch unset it
     stays resident under the default budget and streams under a budget
     one byte below its level sets, with the same mesh.
 16. several shards in one process (run after phase 15, before phase 14):
     four virtual shards on the card (``parallel.mesh.set_devices``), or
     one shard per card where there are several; the default list is
     restored after. (a) ``compute_particle_densities_sharded`` on the 2M
     dam break (geoslot, slabs of the bin lattice) against the single-device
     densities: bit for bit, K2 launched once per shard, both timed (median
     of 5); (b) three canyon frames of phase 7's parameters, sharded: the
     sharded decomposition, per-shard B, pairs, K3 launches and stage
     seconds, stage peaks, the mesh closed and equal to phase 7's resident
     mesh (bit for bit, or within 1e-6 with equal triangle lists where a sum
     ran with atomics), the warm frame against phase 7's; (c)
     ``reconstruct_surface`` on the canyon with default parameters: the
     subdomain route, sharded, not the slab route, its mesh equal to (b)'s
     and its counts within 1e-4 of phase 13's slab mesh; (d) the JAX
     package's dry-run scene (a sheet and a dense clump, 8-cell subdomains)
     on 8 virtual shards against one device: the same mesh.
 17. the rest of the JAX package's API on phase 4's 2M dam break and grid
     (run after phase 4): (a) v = m / rho from the geoslot densities (K2),
     the dense route's level set (K1), and ``density.splat_level_set`` (4
     slots) and ``splat_level_set_scatter`` against it within rtol 2e-5,
     atol 1e-4, each timed (plain PyTorch, as the reference's are plain
     JAX); ``splat_level_set_auto`` on a 100K cloud with a 2000-particle
     clump, which must retry; (b) ``mc.marching_cubes_padded`` on that level
     set with exact capacities: equal to ``mc.marching_cubes``, the dense
     route's triangle count, and ``decode_edge_flat`` inverting
     ``edge_layout``; (c) the geoslot hysteresis: three colliding density
     calls, then the dam break takes the raster densities (K2) with
     ``try_geoslot`` off, and geoslot again after
     ``reset_geoslot_hysteresis()``, both within rtol 2e-5 of the f64
     densities; (d) ``cubic_kernel_gradient`` and
     ``DiscreteSquaredDistanceCubicKernel`` on the card against float64.
     Phases whose densities must take geoslot (2, 4, 16, 17, 18) first
     reset the process-global hysteresis.
 18. the frame plans (run after phase 4): frames of phase 4's scene, pts +
     k 1e-6, each warm frame on the plans of the frame before it, dispatched
     under ``torch.cuda.set_sync_debug_mode("error")`` up to its
     ``resolve()``, with K1 and K2 launched once and one frame counted, no
     miss; each frame warm on its own plans equal to its plan-cleared run
     (counts, vertices within 1e-6); the warm and plan-cleared seconds,
     synchronising calls and the card's idle share (``torch.profiler``); a
     frame shifted past a grid cell misses its grid plan.
 19. the mesh pulls (run after phase 16, while the canyon is on the card):
     the 2M dam break on the dense route with the packed pull, the encoded
     pull with u16 and with f32 edge parameters, and edge-major marching
     cubes (``SPLASHSURF_TPU_PULL``, ``_PULL_QUANT``, ``_MC``), each a cold
     and five warm frames on the plans (no synchronising call up to
     ``resolve()``, K1 and K2 once): the bytes copied, the host decode and
     device MC seconds, the frame seconds; every mode's mesh the packed
     one's triangle list, vertices within 4 float32 ulps (plus cell_size /
     65535 * 1.01 with u16 t); every f32 decode native. The 8M canyon on default
     parameters (slabs), packed against encoded, and on the subdomain route,
     the stitch against the encoded pull (``SPLASHSURF_TPU_SUB_ENCODED_PULL``)
     with the stage split and without the stage synchronisation, then one
     streamed and one four-shard encoded frame, both the resident encoded
     mesh. The subdomain route's stage clock synchronises the card only
     with ``subdomains.enable_profile_sync(True)``, which this script turns
     on for every phase that prints its stage seconds.
 20. the single-dispatch warm frame (run after phase 18), one CUDA graph
     per plan set, at most one live: with ``SPLASHSURF_TPU_MONO_FRAME=1``
     and ``_PREWARM=1`` the planning frame captures the graph and five
     warm frames of phase 18's ``pts + k 1e-6`` replay it once each, its
     capture having queued K1, K2 and K6 once each (the wrappers count eager
     launches and captured ones apart; a profiler trace of each replay is
     logged), the replays' device milliseconds between CUDA events,
     the meshes and densities those of the per-stage frames on the same
     plans bit for bit; the seconds, idle shares, graph pool, capture
     seconds and the planning frame's cost; a caps, a density and a grid
     miss each give the per-stage mesh and a fresh graph; the encoded
     pull's replays within ``pull_tol`` of the packed ones; numpy frames
     on six grid origins one cell apart, a capture each with one graph
     live after each and the reserved memory bounded by one graph pool
     (``phase_mono``).
 21. array-like inputs under the device rule (run after phase 17): the 2M
     dam break's positions as a numpy array through
     ``neighbors.compute_particle_densities`` (K2 must launch), equal bit
     for bit to the CUDA-tensor call, with the seconds of both (the numpy
     call copies the positions to the card first); ``cubic_kernel``,
     ``aabb_from_points``, ``Aabb3d.contains_points`` and the
     ``UniformGrid`` tensor methods on numpy input, each result on the card
     and equal to the tensor call's.
 22. the benchmark entry point (run last): ``splashsurf_tpu_torch.bench.main``
     in-process for the scenes of ``tests/goldens/torch_fullwidth.json``
     (the default mode in f32 and f64, ``--frames 6``, ``--sparse``, the
     13.35M dam break in f64) and each ``--stage`` at 3 repeats, from no
     plan: each JSON line logged
     with the card's name and power limit, each mesh summary within its
     bar of the JAX package's, on its route; K1 and K2 launched in the
     frame modes, K1 once per slab of each ``--sparse`` frame, K2 in
     ``--stage density``, K1 in ``--stage mc`` (``phase_bench``).
 23. kernel K5 (the binned densities' sweep, run after phase 4) against its
     plain version on the benchmark's sheared 13.2M dam-break frame k = 4
     (made on the card by ``benchmark/harness/scenes.py``; K = 16, u_cap
     2^21) and on the 2M dam break sheared the same way, f32, and the 2M
     frame in f64: kernel (median of 10) and plain (median of 3) times
     beside the bound of the position-counted pairs, the compiler's
     registers and the largest relative gap to the plain version in f64;
     then ``reconstruct_surface`` on the benchmark's sheared 13.2M frames
     k = 1-4 as numpy (the dense route, binned densities, as the
     ``host_flow`` cell runs them): K5 launched once per density pass
     (the ``binned sweep`` spans), while phase 4's geoslot frames launched
     it 0 times (``phase_k5``).
 24. the upload of a numpy frame (run after phase 23): the benchmark's
     13.2M frame k = 4 as the ``host_flow`` cell hands it over (float32
     numpy), and the same frame in float64, through the pageable copy
     (``torch.as_tensor(..., device=cuda)``) against
     ``placement.as_device_tensor``'s staged copy through pinned chunks:
     host milliseconds until the call returns, device milliseconds between
     CUDA events around it, and milliseconds until the copy is done, each a
     median of 10, with the rates; the staged copy at chunks of 4, 16 and
     64 MiB; the staged copy makes no synchronising call under
     ``torch.cuda.set_sync_debug_mode("warn")`` where the pageable one
     does, and equals it bit for bit (``phase_upload``).
 25. kernel K6 (the slot raster, run after phase 24) against its plain
     version on the benchmark's sheared 13.2M frame k = 4 and on the 2M dam
     break, f32, weights m / rho: kernel (median of 10) and plain (median of
     5) times beside the bound of its bytes (the rasters written once,
     positions and weights read once, the claim tables, the overflow mask),
     the compiler's registers; the rasters and the overflow mask bit for bit
     equal to the plain version run on the host (and the count of entries
     where the plain version on the card differs: its division by a host
     scalar multiplies by the reciprocal); the meta and float64 on the 2M
     frame, bit for bit; then ``reconstruct_surface`` on the benchmark's
     sheared 13.2M frames k = 1-4 as numpy: K6 launched once per raster run
     (the ``dense raster`` spans, overflow retries included) (``phase_k6``).

Each kernel's line carries its bound: the larger of the bytes it must move
(rasters read once, output written once) over 3.35 TB/s and the float
operations this run's data needs over 67 TFLOP/s (an H100 SXM's data-sheet
peaks at 700 W; the card's power limit is printed beside). For K1 and K3
those are the occupied terms within the support radius: the cells wholly
beyond it add exactly 0, and the kernels leave them out. For K2 and K4 they
are the distance of every occupied (query, source) pair and the spline of
the pairs within the support (beyond it the term is exactly 0, and the
kernels skip it), and their bytes are fx in full (the occupancy pre-pass
reads it), fy and fz only in the 32-byte sectors that hold an occupied
entry, and the output; the earlier count, every raster entry read and a
whole term for every occupied pair, is printed beside. No single PyTorch
call computes these functions, so ``library_ms`` is null.

The line before the last is a JSON object of the kernels' launches, errors,
times and bounds; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any result.
"""

import contextlib
import json
import math
import os
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
# float operations counted in the kernels' loops (sqrt and max count one
# each). K1/K3, per occupied term within the support: 23 (offset adds 4, d2
# 5, q 2, the two clamped cubes 8, weight and sum 4).
FLOPS_TERM = 23
# K2/K4, per occupied (query, source) pair: its distance, K2 9 (differences
# 3, d2 5, the cut's compare 1), K4 12 (and the offset adds 3); K2 adds its
# 3 offset adds once per occupied source a lane visits. Per pair within the
# support: the spline, 14 (q 2, cubes 8, combine and sum 4).
FLOPS_D2 = {"density_sweep": 9, "pair_sweep": 12, "binned_sweep": 9}
FLOPS_SOURCE = 3
FLOPS_SPLINE = 14
FLOPS_PAIR_OLD = 22  # the earlier count: a whole term for every occupied pair
CELLRASTER = "SPLASHSURF_TPU_DENSITY_CELLRASTER"
N_FRAMES = 6
N_PIPE = 60_000
PIPE_TOL = dict(rtol=2e-5, atol=1e-5)
# the user's command of phase 11 (input and output files appended)
CLI_FLAGS = ["-r", str(RADIUS), "-l", "2.0", "-c", "1.5", "-t", "0.6",
             "--mesh-cleanup=on", "--decimate-barnacles=on", "--mesh-smoothing-iters=25",
             "--mesh-smoothing-weights=on", "--normals=on", "--sph-normals=on",
             "--normals-smoothing-iters=10", "-a", "velocity", "--check-mesh=on"]


def log(msg):
    print(msg, flush=True)


def reset_launches(sk):
    """Set every kernel's launch count to 0, just before a main path runs."""
    for fn in sk.WRAPPERS:
        fn.launches = 0


def check_mask_launches(sk, sweeps):
    """Every sweep launch of a main path (K1, K3 or K4) built its occupancy
    masks first, and every K2 launch its slot bytes."""
    n = sk.occupancy_masks_cuda.launches
    if n != sweeps:
        raise AssertionError(f"{n} mask pre-pass launches for {sweeps} K1, K3 and K4 sweeps")
    n2, k2 = sk.bin_occupancy_cuda.launches, sk.density_sweep_cuda.launches
    if n2 != k2:
        raise AssertionError(f"{n2} slot-byte pre-pass launches for {k2} K2 sweeps")
    return n


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


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float operations over the float32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def needed_bytes(fr, out):
    """The bytes K2 or K4 must move on the fraction rasters ``fr``: fx in
    full (the occupancy pre-pass reads every entry), of fy and fz only the
    32-byte sectors that hold an occupied entry (the kernels load them at
    a set bit only), the output in full."""
    fx = fr[0]
    per = 32 // fx.element_size()
    occ = (fx < 1e14).reshape(-1)
    occ = torch.cat([occ, occ.new_zeros(-occ.numel() % per)])
    sectors = int(occ.reshape(-1, per).any(dim=1).sum())
    return nbytes(fx, out) + 2 * 32 * sectors


def pair_bounds(name, n_bytes, old_bytes, terms):
    """The bound of K2 or K4 from ``n_bytes`` (``needed_bytes``) and
    ``terms`` (``density_terms`` or ``pair_terms``), and the bound of the
    earlier count (every raster entry read, a whole term per occupied pair),
    each as (ms, by); logs the two parts of the bound."""
    flops = (terms["pairs"] * FLOPS_D2[name] + terms["under"] * FLOPS_SPLINE
             + terms.get("sources", 0) * FLOPS_SOURCE)
    log(f"  {name} bound parts: {n_bytes} bytes needed = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"(every raster entry: {old_bytes} bytes), {flops} operations = "
        f"{flops / F32_FLOPS * 1e3:.4f} ms")
    return bound(n_bytes, flops), bound(old_bytes, terms["pairs"] * FLOPS_PAIR_OLD)


def sweep_offsets(hsc, pad, h_over_cs=None):
    """The cell offsets (shifted by pad) of a level-set sweep: the whole
    fan gather_cell_offsets(hsc), or with ``h_over_cs`` the kernels' run
    table, which leaves out the cells wholly beyond the support radius."""
    from splashsurf_tpu_torch.density import gather_cell_offsets
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    if h_over_cs is None:
        return [tuple(o) for o in (gather_cell_offsets(hsc) + pad).tolist()]
    return [(a, b, c) for a, b, lo, hi in sk.sweep_runs(hsc, pad, h_over_cs).tolist()
            for c in range(lo, hi)]


def sweep_terms(fv, offsets, n_points):
    """Occupied (point, offset, slot) terms of a level-set sweep (K1, K3):
    for every offset, the non-empty raster entries in its window of the
    points."""
    total = 0
    for o in offsets:
        sl = (...,) + tuple(slice(int(a), int(a) + n) for a, n in zip(o, n_points))
        total += int(torch.count_nonzero(fv[sl]))
    return total


def log_block_geometry(sk, kind, n_runs, pad):
    """The block geometry that the library launches for two slots
    (``sk.kernel_geometry``: the level-set sweep, or K4 with ``pad`` its
    reach), held to the host's copies that the CPU emulations and the
    occupancy reports use; logs the dynamic shared memory per block."""
    tile, words, f32 = sk.kernel_geometry(kind, n_runs, 2, pad, torch.float32)
    host = ((sk.SWEEP_TILE, sk.window_words(pad)) if kind == "sweep"
            else (sk.PAIR_TILE, sk.pair_window_words(pad)))
    if (tile, words) != host:
        raise AssertionError(f"{kind}: the library's tile {tile} and {words} window words "
                             f"differ from the host's {host}")
    f64 = sk.kernel_geometry(kind, n_runs, 2, pad, torch.float64)[2]
    log(f"  dynamic shared memory per {tile} tile block (from the library): {f32} bytes "
        f"(f32), {f64} (f64); {words} mask words per window row, as the host's copy")


def ptxas_report(sk, source, names):
    """The compiler's lines (registers, shared memory, spills) for the
    entry functions of ``source`` whose names contain one of ``names``."""
    out, src, keep = [], "", False
    for line in (sk.build_kernels().parent / "build.log").read_text().splitlines():
        if " -c " in line:  # the command line that starts a source's report
            src, keep = line, False
        elif "Compiling entry" in line:
            keep = source in src and any(n in line for n in names)
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def occupancy_report(sk, fv, masks, hsc, pad, h_over_cs, n_points):
    """How full the rasters (..., S, Xp, Yp, Zp) are, as the sweep sees
    them: each slot's share of occupied entries; the occupied terms among
    the probes of the whole fan (what the probing design visited), and
    those within the support (what the kernels walk); the share of sweep
    tiles whose staged mask window is empty, per slot and in every slot."""
    S, Xp, Yp, Zp = fv.shape[-4:]
    C = fv.numel() // (S * Xp * Yp * Zp)
    fill = [float((fv.reshape(C, S, -1)[:, s] != 0).double().mean()) for s in range(S)]
    fan = sweep_offsets(hsc, pad)
    terms = sweep_terms(fv, fan, n_points)
    walked = sweep_terms(fv, sweep_offsets(hsc, pad, h_over_cs), n_points)
    probes = C * math.prod(n_points) * S * len(fan)
    TX, TY, TZ = sk.SWEEP_TILE
    nww = sk.window_words(pad)
    wx, wy = TX + 2 * pad - 1, TY + 2 * pad - 1
    occ = (masks.reshape(C * S, 1, Xp, Yp, masks.shape[-1]) != 0).float()
    occ = torch.nn.functional.pad(occ, (0, nww, 0, wy, 0, wx))
    win = torch.nn.functional.max_pool3d(occ, (wx, wy, nww), stride=(TX, TY, 1))
    tiles = [-(-n // t) for n, t in zip(n_points, (TX, TY, TZ))]
    full = win[:, 0, : tiles[0], : tiles[1], : tiles[2]].reshape(C, S, -1) > 0
    skip = [float((~full[:, s]).double().mean()) for s in range(S)]
    empty = float((~full.any(dim=1)).double().mean())
    log(f"  occupancy: slot fill {[f'{f:.4%}' for f in fill]}; occupied terms {terms} of "
        f"{probes} fan probes ({terms / probes:.3%}), {walked} within the support; "
        f"{TX}x{TY}x{TZ} tiles skipping each slot {[f'{x:.2%}' for x in skip]}, every slot "
        f"{empty:.2%} of {full.shape[0] * full.shape[2]}")


def edge_rasters(shape, dtype, dev, cs, pad, seed):
    """Rasters (..., 2, Xp, Yp, Zp) that probe the sweep's edges: only slot
    1 occupied; occupied entries on mask-word boundaries only; a lone
    particle at each corner of the padded raster and at each corner cell of
    the points' own region (pad + {0, n - 1} per axis), in slot 0, and at
    the far corners in slot 1. The fan never reaches the padded corners:
    the kernel must stage them and add nothing."""
    rng = np.random.default_rng(seed)
    far = np.inf if dtype == torch.float32 else 1e15
    Xp, Yp, Zp = shape[-3:]
    slot1 = np.zeros(shape, bool)
    slot1[..., 1, :, :, :] = rng.uniform(size=slot1[..., 1, :, :, :].shape) < 0.3
    words = np.zeros(shape, bool)
    zs = sorted({z for z in (0, 31, 32, 33, 63, 64, 95, 96, Zp - 1) if z < Zp})
    words[..., zs] = rng.uniform(size=words[..., zs].shape) < 0.5
    corners = np.zeros(shape, bool)
    for lo, hi in ((0, 1), (pad, 2 * pad)):
        for i in (lo, Xp - hi):
            for j in (lo, Yp - hi):
                for k in (lo, Zp - hi):
                    corners[..., 0, i, j, k] = True
        corners[..., 1, Xp - hi, Yp - hi, Zp - hi] = True
    out = []
    for name, occ in (("only slot 1", slot1), ("word edges", words), ("corners", corners)):
        fr = rng.uniform(0, cs, (3,) + shape)
        v = rng.uniform(0.5, 1.0, shape)
        fr[:, ~occ] = far
        v[~occ] = 0.0
        out.append((name, [torch.as_tensor(a, dtype=dtype, device=dev) for a in (*fr, v)]))
    return out


def check_masks(sk, name, fv, fractions=False):
    """The mask pre-pass bit-equal to its plain version; returns the masks."""
    got = sk.occupancy_masks_cuda(fv, fractions)
    if not torch.equal(got, sk.occupancy_masks_plain(fv, fractions)):
        raise AssertionError(f"{name}: occupancy masks differ from the plain version")
    log(f"  {name}: occupancy masks {tuple(got.shape)} bit-equal to the plain version")
    return got


def density_terms(fr, bin_size, cut2):
    """What K2 must compute on the (8, LX+2, Yp, Zp) rasters ``fr``: the
    occupied query slots, the occupied (query, source) pairs over the 27
    neighbour bins, those with d2 <= cut2 (within the support, in the plain
    version's arithmetic), and the occupied sources the lanes holding a
    query visit."""
    fx = fr[0]
    t = np.float32 if fx.dtype == torch.float32 else np.float64
    occ = (fx < 1e14).sum(dim=0).to(torch.float64)  # (LX+2, Yp, Zp)
    X, Y, Z = occ.shape
    inner = (slice(1, X - 1), slice(1, Y - 1), slice(1, Z - 1))
    q = occ[inner]
    fq = [f[(slice(None),) + inner] for f in fr]
    qocc = fx[(slice(None),) + inner] < 1e14
    pairs = under = sources = 0
    for a in range(3):
        for b in range(3):
            for c in range(3):
                sl = (slice(a, a + X - 2), slice(b, b + Y - 2), slice(c, c + Z - 2))
                pairs += int((q * occ[sl]).sum())
                sources += int(occ[sl][q > 0].sum())
                od = [float(t(o - 1) * t(bin_size)) for o in (a, b, c)]
                win = [f[(slice(None),) + sl] for f in fr]
                for k in range(fx.shape[0]):
                    d2 = sum((fq[d] - (win[d][k] + od[d])[None]) ** 2 for d in range(3))
                    # both occupied (two f64 sentinels 1e15 lie close)
                    both = qocc & (win[0][k] < 1e14)[None]
                    under += int(((d2 <= cut2) & both).sum())
    return dict(queries=int(q.sum()), pairs=pairs, under=under, sources=sources)


def pair_terms(fr, cs, reach, h_over_cs, pad, n_cells, cut2):
    """What K4 must compute on the (S, Xp, Yp, Zp) rasters ``fr``: the
    occupied query slots, the occupied (query, source) pairs over the pruned
    fan, and those with d2 <= cut2 (within the support, in the plain
    version's arithmetic)."""
    from splashsurf_tpu_torch.ops.splat_kernels import pair_cell_offsets

    fx = fr[0]
    t = np.float32 if fx.dtype == torch.float32 else np.float64
    S = fx.shape[0]
    occ = (fx < 1e14).sum(dim=0).to(torch.float64)  # (Xp, Yp, Zp)
    inner = tuple(slice(pad, pad + n) for n in n_cells)
    q = occ[inner]
    fq = [f[(slice(None),) + inner] for f in fr]
    qocc = fx[(slice(None),) + inner] < 1e14
    pairs = under = 0
    for o in pair_cell_offsets(reach, h_over_cs):
        sl = tuple(slice(pad + a, pad + a + n) for a, n in zip(o, n_cells))
        pairs += int((q * occ[sl]).sum())
        od = [float(t(a) * t(cs)) for a in o]
        win = [f[(slice(None),) + sl] for f in fr]
        for k in range(S):
            d2 = sum((fq[d] - (win[d][k] + od[d])[None]) ** 2 for d in range(3))
            both = qocc & (win[0][k] < 1e14)[None]  # two f64 sentinels lie close
            under += int(((d2 <= cut2) & both).sum())
    return dict(queries=int(q.sum()), pairs=pairs, under=under)


def log_bounds(name, ms, prepass_ms, plain_ms, b, b_old, terms):
    log(f"  {name}: kernel {ms:.3f} ms (of which the pre-pass {prepass_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}; the earlier count gives "
        f"{b_old[0]:.4f} ms, {b_old[1]}); {ms / b[0]:.1f}x the bound")
    n = max(terms["queries"], 1)
    log(f"  {name} work: {terms['queries']} queries, {terms['pairs'] / n:.2f} occupied pairs "
        f"and {terms['under'] / n:.2f} within the support per particle "
        f"({terms['under'] / max(terms['pairs'], 1):.2%})")


def k4_occupancy_report(sk, fx, masks, reach, pad, n_cells):
    """How K4's tiles see the fraction rasters (S, Xp, Yp, Zp): the query
    fill per slot; the 32-cell z segments that hold a query and their
    queries; the tiles whose staged mask window holds no set bit, per slot
    (the block skips that slot) and in every slot."""
    S, Xp, Yp, Zp = fx.shape
    ncx, ncy, ncz = n_cells
    qocc = fx[(slice(None),) + tuple(slice(pad, pad + n) for n in n_cells)] < 1e14
    fill = [float(qocc[s].double().mean()) for s in range(S)]
    seg = torch.nn.functional.pad(qocc.float(), (0, -ncz % 32)).reshape(S, ncx, ncy, -1, 32).sum(-1)
    busy = seg > 0
    TX, TY, TZ = sk.PAIR_TILE
    nww = sk.pair_window_words(reach)
    wx, wy = TX + 2 * reach, TY + 2 * reach
    occ = (masks.reshape(S, 1, Xp, Yp, masks.shape[-1]) != 0).float()[
        :, :, pad - reach :, pad - reach :, (pad - reach) >> 5 :]
    occ = torch.nn.functional.pad(occ, (0, nww, 0, wy, 0, wx))
    win = torch.nn.functional.max_pool3d(occ, (wx, wy, nww), stride=(TX, TY, 1))
    tiles = [-(-n // t) for n, t in zip(n_cells, (TX, TY, TZ))]
    full = win[:, 0, : tiles[0], : tiles[1], : tiles[2]].reshape(S, -1) > 0
    skip = [float((~full[s]).double().mean()) for s in range(S)]
    log(f"  K4 occupancy: query fill {[f'{f:.4%}' for f in fill]}; busy 32-cell segments "
        f"{float(busy.double().mean()):.2%}, {float(seg[busy].mean()):.2f} queries per busy one; "
        f"{TX}x{TY}x{TZ} tiles skipping each slot {[f'{x:.2%}' for x in skip]}, every slot "
        f"{float((~full.any(0)).double().mean()):.2%} of {full.shape[1]}")


def k2_occupancy_report(fx):
    """How full K2's lattice (8, LX+2, Yp, Zp) is: the query fill per slot,
    the lanes and the 32-lane warps that hold a query."""
    S, Xp, Yp, Zp = fx.shape
    W = (Yp - 2) * Zp
    q = fx.reshape(S, Xp, Yp * Zp)[:, 1:-1, Zp + 1 : Zp + 1 + W] < 1e14  # (8, LX, W)
    lanes = q.any(0).reshape(-1)
    warps = torch.nn.functional.pad(lanes, (0, -lanes.numel() % 32)).reshape(-1, 32).any(1)
    log(f"  K2 occupancy: query fill {[f'{float(q[s].double().mean()):.2%}' for s in range(S)]}; "
        f"lanes with a query {float(lanes.double().mean()):.2%}, warps with none "
        f"{float((~warps).double().mean()):.2%} of {warps.numel()}")


def pair_edge_rasters(n_cells, pad, dtype, dev, cs, h, seed):
    """Fraction rasters (2, Xp, Yp, Zp), Xp = ncx + 2 pad, that probe K4's
    edges: only slot 1 occupied; queries on mask-word and tile boundaries
    only; a query in each corner cell of the grid and a source in each
    corner of the padded raster, in both slots; pairs at d = h (1 +- 1e-6)
    and h (1 +- 1e-3), just inside and just outside the support."""
    rng = np.random.default_rng(seed)
    far = np.inf if dtype == torch.float32 else 1e15
    t = np.float32 if dtype == torch.float32 else np.float64
    shape = (2,) + tuple(n + 2 * pad for n in n_cells)
    Xp, Yp, Zp = shape[1:]
    out = []
    occ = np.zeros(shape, bool)
    occ[1] = rng.uniform(size=shape[1:]) < 0.3
    out.append(("only slot 1", occ))
    occ = np.zeros(shape, bool)
    zs = [z for z in (31, 32, 33, 63, 64, 65, 95, 96) if z < Zp]
    xs = [pad + x for x in range(n_cells[0]) if x % 4 in (0, 3)]
    ys = [pad + y for y in range(n_cells[1]) if y % 8 in (0, 7)]
    occ[np.ix_([0, 1], xs, ys, zs)] = rng.uniform(size=(2, len(xs), len(ys), len(zs))) < 0.6
    out.append(("word and tile edges", occ))
    occ = np.zeros(shape, bool)
    for i in (0, pad, Xp - pad - 1, Xp - 1):
        for j in (0, pad, Yp - pad - 1, Yp - 1):
            for k in (0, pad, Zp - pad - 1, Zp - 1):
                occ[:, i, j, k] = True
    out.append(("corners", occ))
    res = []
    for name, occ in out:
        fr = rng.uniform(0, cs, (3,) + shape).astype(t)
        fr[:, ~occ] = far
        res.append((name, fr))
    # pairs across the support: queries in slot 0 of one cell in every
    # other (x, y) row, each with a source in slot 1 at d = h (1 + eps) along
    # a random direction
    fr = np.full((3,) + shape, far, t)
    eps = (1e-6, -1e-6, 1e-3, -1e-3)
    i = 0
    for x in range(pad, pad + n_cells[0]):
        for y in range(pad + 1, pad + n_cells[1] - 1, 2):
            z = pad + 1 + (x + y) % (n_cells[2] - 2)
            f0 = rng.uniform(0.3 * cs, 0.7 * cs, 3)
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            p = np.array([x, y, z]) * cs + f0 + h * (1 + eps[i % 4]) * u
            c = np.floor(p / cs).astype(int)
            if (c < pad).any() or (c >= np.array(shape[1:]) - pad).any() or fr[0, 1][tuple(c)] < 1e14:
                continue
            fr[:, 0, x, y, z] = f0
            fr[:, 1][(slice(None),) + tuple(c)] = p - c * cs
            i += 1
    res.append((f"{i} pairs across the support", fr))
    return [(name, [torch.as_tensor(a, device=dev) for a in fr]) for name, fr in res]


def straddle_lattice(dtype, dev, h, seed):
    """Bin rasters (8, LX+2, LY+2, LZ+2), bin size h, in which slot 0 of
    every interior bin has a particle and slot 1 of the next bin along x one
    at d = h (1 + eps) from it, eps in +-1e-7, +-1e-5, +-1e-3: pairs just
    inside and just outside the support."""
    rng = np.random.default_rng(seed)
    far = np.inf if dtype == torch.float32 else 1e15
    LX, LY, LZ = 6, 10, 12
    fr = np.full((3, 8, LX + 2, LY + 2, LZ + 2), far)
    eps = np.array([1e-7, -1e-7, 1e-5, -1e-5, 1e-3, -1e-3])
    inner = (slice(1, LX), slice(1, LY + 1), slice(1, LZ + 1))
    n = (LX - 1) * LY * LZ
    f0 = rng.uniform(0.25 * h, 0.5 * h, (3, n))
    e = eps[np.arange(n) % eps.size]
    for d in range(3):
        fr[d, 0][inner] = f0[d].reshape(LX - 1, LY, LZ)
    nxt = (slice(2, LX + 1), slice(1, LY + 1), slice(1, LZ + 1))
    fr[0, 1][nxt] = (f0[0] + h * e).reshape(LX - 1, LY, LZ)
    for d in (1, 2):
        fr[d, 1][nxt] = f0[d].reshape(LX - 1, LY, LZ)
    return LX, [torch.as_tensor(a, dtype=dtype, device=dev).contiguous() for a in fr]


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


def k3_chunk(pt, pts, params, last_chunk=True, streamed=False):
    """The rasters of one splat chunk of ``pts`` as the subdomain route
    builds them: the fullest chunk of the route's own plan (the last of the
    resident plan, which sorts by occupancy; with ``streamed``, the streamed
    plan's chunk of most pairs), or with ``last_chunk`` False every occupied
    subdomain in one chunk."""
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
    if streamed:
        plan = S.stream_plan(counts, sd, pts.element_size(), S.CHUNK_BYTES)
        rows_np = max(plan, key=lambda rows: int(counts[rows].sum()))
    else:
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
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    params = canyon_params(pt)
    h = params.compact_support_radius
    rasters, sd, B, n_chunks = k3_chunk(pt, canyon, params)
    hsc, m, P = sd.margin_cells, sd.margin_cells, sd.points_per_dim
    cs = sd.global_grid.cell_size
    log(f"phase 6: K3 on the fullest of {n_chunks} splat chunks ({B} subdomains), "
        f"rasters {tuple(rasters[0].shape)}")
    for line in ptxas_report(sk, "splat_sweep.cu", ("level_set_tiles",)):
        log("  ptxas " + line)
    log_block_geometry(sk, "sweep", len(sk.sweep_runs(hsc, m + 1, h / cs)), m + 1)
    masks = check_masks(sk, "canyon chunk", rasters[3])
    occupancy_report(sk, rasters[3], masks, hsc, m + 1, h / cs, (P, P, P))
    del masks
    k3 = lambda: sk.splat_sweep_cuda(*rasters, cs, h, hsc, m, P)
    p3 = lambda: sk.splat_sweep_plain(*rasters, cs, h, hsc, m, P)
    out3 = k3()
    err3 = compare("K3 f32", out3, p3(), K3_F32_TOL)
    ms3, pms3 = cuda_ms(k3, 5), cuda_ms(p3, 2)
    b3 = bound(nbytes(*rasters, out3), FLOPS_TERM *
               sweep_terms(rasters[3], sweep_offsets(hsc, m + 1, h / cs), (P, P, P)))
    log(f"  K3 f32: kernel {ms3:.3f} ms (of which the mask pre-pass "
        f"{cuda_ms(lambda: sk.occupancy_masks_cuda(rasters[3]), 5):.4f} ms), plain {pms3:.3f} ms, "
        f"bound {b3[0]:.4f} ms ({b3[1]})")
    del rasters, out3
    small = torch.as_tensor(bench.make_canyon(20_000, RADIUS, seed=5), device=dev).double()
    r64, sd64, B64, _ = k3_chunk(pt, small, params.try_convert("float64"), last_chunk=False)
    compare(
        f"K3 f64 ({B64} subdomains)",
        sk.splat_sweep_cuda(*r64, cs, h, hsc, m, P),
        sk.splat_sweep_plain(*r64, cs, h, hsc, m, P),
        F64_TOL,
    )
    # edge rasters: two subdomains of P = 33 points, not a multiple of 32
    Pe = 33
    for dt, tol in ((torch.float32, K3_F32_TOL), (torch.float64, F64_TOL)):
        shape = (2, 2) + (Pe + 2 * m + 1,) * 3
        for name, r in edge_rasters(shape, dt, dev, cs, m + 1, seed=13):
            check_masks(sk, f"K3 {dt} {name}", r[3])
            compare(f"K3 {dt} {name} {shape}", sk.splat_sweep_cuda(*r, cs, h, hsc, m, Pe),
                    sk.splat_sweep_plain(*r, cs, h, hsc, m, Pe), tol)
    kernels["splat_sweep"] = dict(
        name="splat_sweep", route="cuda",
        source="splashsurf_tpu_torch/csrc/splat_sweep.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:518",
        max_abs_err=err3, ms=ms3, plain_ms=pms3, bound_ms=b3[0], bound_by=b3[1],
        library_ms=None,
    )


def phase_canyon(pt, canyon, kernels, ident):
    """Phase 7: the subdomain route at full size, the main path of K3.
    Returns the mesh of its last frame and its warm median seconds."""
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
    check_mask_launches(sk, launches)
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
        f"{n / warm / 1e6:.3f} Mparticles/s ({ident}); K3 launches {launches}, each "
        f"after its mask pre-pass")
    return mesh, warm


def phase_cross_subdomain(pt, dev, dam):
    """Phase 8: the subdomain route from a CPU input against a CUDA input,
    and against the dense route on the card."""
    from scipy.spatial import cKDTree

    from splashsurf_tpu_torch import bench

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


def check_same_mesh(name, a, b, ordered, tree=None, same_counts=True, tol=1e-4):
    """Equal counts (unless ``same_counts`` is False) and vertices within
    ``tol``: position by position when both lists share an order, else by
    nearest neighbour both ways."""
    if same_counts and (a.num_vertices, a.num_triangles) != (b.num_vertices, b.num_triangles):
        raise AssertionError(
            f"{name}: counts differ: {a.num_vertices}/{a.num_triangles} vs "
            f"{b.num_vertices}/{b.num_triangles}"
        )
    if ordered:
        vdiff = float(np.abs(a.vertices - b.vertices).max()) if a.num_vertices else 0.0
    else:
        vdiff = max(float(tree(b.vertices).query(a.vertices)[0].max()),
                    float(tree(a.vertices).query(b.vertices)[0].max()))
    if vdiff >= tol:
        raise AssertionError(f"{name}: vertices differ by {vdiff}")
    same = ordered and bool((a.triangles == b.triangles).all())
    counts = f"{a.num_vertices} vertices, {a.num_triangles} triangles"
    if (a.num_vertices, a.num_triangles) != (b.num_vertices, b.num_triangles):
        counts += f" against {b.num_vertices}, {b.num_triangles}"
    log(f"  {name}: {counts}; max vertex "
        f"diff {vdiff:.3e}" + (f"; triangle lists equal: {same}" if ordered else ""))


def phase_k2(dev, pts, h, kernels):
    """Phase 3: K2 against its plain version on the geoslot lattice of the
    2M dam break (f32, timed with its slot-byte pre-pass), on a lattice
    wider than 5376 lanes, an f64 lattice and one whose pairs straddle the
    support radius."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    lo, hi = torch.aminmax(pts, dim=0)
    phases = N._octant_phase(pts, h / 2.0)
    agrid = N._phase_aligned_bingrid(lo.cpu().numpy(), hi.cpu().numpy(), h, phases)
    drast, _, ok = N.geoslot_rasters(pts, agrid)
    if not bool(ok):
        raise AssertionError("geoslot octant check failed on the dam break")
    LX = agrid.dims[0]
    log(f"phase 3: K2 on lattice {agrid.dims}, rasters {tuple(drast[0].shape)}")
    for line in ptxas_report(sk, "density_sweep.cu", ("density_sweep_kernel", "bin_occupancy")):
        log("  ptxas " + line)
    k2_occupancy_report(drast[0])
    got = sk.bin_occupancy_cuda(drast[0])
    if not torch.equal(got, sk.bin_occupancy_plain(drast[0])):
        raise AssertionError("K2 slot bytes differ from the plain version")
    log(f"  slot bytes {tuple(got.shape)} bit-equal to the plain version")

    def occupied(r):
        S, _, Yp, Zp = r[0].shape
        W = (Yp - 2) * Zp
        q = r[0].reshape(S, -1, Yp * Zp)[:, 1 : 1 + r[0].shape[1] - 2, Zp + 1 : Zp + 1 + W]
        return q < 1e14  # empty query slots hold the far sentinel

    def check(name, r, LXr, bs, tol):
        occ = occupied(r)
        out = sk.density_sweep_cuda(*r, LXr, bs, h)
        err = compare(name, out, sk.density_sweep_plain(*r, LXr, bs, h), tol, occ)
        if bool((out[~occ] != 0).any()):
            raise AssertionError(f"{name}: a nonzero sum on an empty query slot")
        return out, err

    out2, err2 = check("K2 f32", drast, LX, agrid.bin_size, F32_TOL)
    k2 = lambda: sk.density_sweep_cuda(*drast, LX, agrid.bin_size, h)
    ms2, pms2 = cuda_ms(k2, 10), cuda_ms(lambda: sk.density_sweep_plain(*drast, LX, agrid.bin_size, h), 3)
    pre2 = cuda_ms(lambda: sk.bin_occupancy_cuda(drast[0]), 10)
    terms = density_terms(drast, agrid.bin_size, sk.support_cut2(h, drast[0].dtype))
    b2, b2_old = pair_bounds("density_sweep", needed_bytes(drast, out2), nbytes(*drast, out2),
                             terms)
    log_bounds("K2 f32", ms2, pre2, pms2, b2, b2_old, terms)
    log(f"  K2 sources visited per particle {terms['sources'] / max(terms['queries'], 1):.2f}")
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
        check(f"K2 {dt} lattice {(LXw, LY, LZ)} (W = {LY * (LZ + 2)})", wr, LXw, h, tol)
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        LXs, sr = straddle_lattice(dt, dev, h, seed=17)
        check(f"K2 {dt} pairs straddling the support", sr, LXs, h, tol)
    kernels["density_sweep"] = dict(
        name="density_sweep", route="cuda",
        source="splashsurf_tpu_torch/csrc/density_sweep.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:202",
        max_abs_err=err2, ms=ms2, plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
        library_ms=None,
    )


def benchmark_dam_break():
    """The benchmark's scene code (``benchmark/harness/scenes.py``), the
    ``dam_break_13m`` configuration and its cycle length (host_flow's)."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmark"))
    from harness import files, scenes

    cfg = files.load_json(files.HERE / "configs" / "dam_break_13m.json")
    cycle = files.load_json(files.HERE / "traffic" / "host_flow.json")["cycle_frames"]
    return scenes, cfg, int(cycle)


def benchmark_motion(pts, k):
    """``pts`` (float32 on the card) moved as frame k of the benchmark's
    16-frame dam-break cycle (``benchmark/motions/shear.py``)."""
    scenes, cfg, cycle = benchmark_dam_break()
    spacing = 2.0 * float(cfg["particle_radius"])
    return pts + scenes.displacement(pts, cfg["motion"], spacing, k, cycle)


def benchmark_dam_frame(k, dev, seed=1):
    """Frame k of the benchmark's ``dam_break_13m`` cycle, made on the card
    by its own scene code (the seed orders the particles only)."""
    scenes, cfg, _ = benchmark_dam_break()
    return benchmark_motion(scenes.base_positions(cfg, seed, dev), k)


def binned_terms(N, grid, cl, tables, K, cut2):
    """What K5 must compute on the cell list: its queries (the first K of
    each occupied bin's run), the (query, source) pairs over the 27
    neighbour bins (the first K of each), and those with d2 <= cut2."""
    bin_rank, occ, run_start, rank_table = tables
    R, lattice = occ.shape[0], grid.lattice
    _, dy, dz = grid.dims
    pos = cl.sorted_positions
    n = pos[0].shape[0]
    slot = torch.arange(n, device=occ.device) - run_start[bin_rank.clamp_max(R)]
    qi = torch.nonzero((slot < K) & (bin_rank < R)).squeeze(1)
    qp = [p[qi] for p in pos]
    b = occ[bin_rank[qi]]
    pairs = under = 0
    for o in N._STENCIL.tolist():
        t = b + (o[0] * dy * dz + o[1] * dz + o[2])
        inside = (t >= 0) & (t < lattice)
        if rank_table is not None:
            rn = rank_table[t.clamp(0, lattice - 1)]
        else:
            rn = torch.searchsorted(occ, t).clamp_max(R - 1)
            rn = torch.where(occ[rn] == t, rn, -1)
        present = inside & (rn >= 0)
        rn = torch.where(present, rn, 0)
        s0 = run_start[rn]
        cnt = torch.where(present, torch.clamp_max(run_start[rn + 1] - s0, K), 0)
        pairs += int(cnt.sum())
        for k in range(K):
            j = (s0 + k).clamp_max(n - 1)
            d2 = sum((qp[d] - pos[d][j]) ** 2 for d in range(3))
            under += int(((cnt > k) & (d2 <= cut2)).sum())
    return dict(queries=int(qi.numel()), pairs=pairs, under=under)


def phase_k5(pt, dev, pts, params, kernels, ident):
    """Phase 23: K5 against its plain version on the benchmark's sheared
    13.2M frame and a sheared 2M frame, timed beside its bound, then the
    dense route's binned frames launching it once per density pass."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import profiling
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    h = params.compact_support_radius
    log(f"phase 23: K5 (binned sweep) ({ident})")
    for line in ptxas_report(sk, "binned_sweep.cu", ("binned_sweep",)):
        log("  ptxas " + line)
    frames = {
        "13.2M dam frame 4": benchmark_dam_frame(4, dev),
        "2M dam frame 4": benchmark_motion(pts, 4),
    }
    entry = None
    for name, f in frames.items():
        lo, hi = torch.aminmax(f, dim=0)
        grid = N.BinGrid.for_domain(lo.cpu().double().numpy(), hi.cpu().double().numpy(), h)
        cl = N.build_cell_list(f, grid)
        max_occ, n_bins, over8 = N.bin_stats_ex(cl)
        gate = N.density_gate(len(f), grid.lattice, n_bins, max_occ, over8)
        plan = N.binned_plan(len(f), grid.lattice, n_bins, max_occ, over8)
        K, u_cap = plan["capacity"], plan["u_cap"]
        log(f"  {name}: {len(f)} particles, lattice {grid.dims}, {n_bins} occupied bins "
            f"(mean {len(f) / n_bins:.2f}), max_occ {max_occ}, over8 {over8}; raster "
            f"{gate['use_raster']}, plan {plan['kind']} K = {K}, u_cap {u_cap}")
        tables = N.binned_sweep_inputs(grid, cl, u_cap)
        args = (*cl.sorted_positions, *tables)
        k5 = lambda: sk.binned_sweep_cuda(*args, K, grid.dims, h)
        plain = lambda: sk.binned_sweep_plain(*args, K, grid.dims, h)
        out5 = k5()
        want = plain()
        err5 = compare(f"K5 f32 {name}", out5, want, F32_TOL)
        ms5, pms5 = cuda_ms(k5, 10), cuda_ms(plain, 3)
        want64 = sk.binned_sweep_plain(*(p.double() for p in cl.sorted_positions), *tables, K,
                                       grid.dims, h)
        q = want64 != 0
        gap = float(((out5.double() - want64).abs()[q] / want64.abs()[q]).max())
        terms = binned_terms(N, grid, cl, tables, K, sk.support_cut2(h, f.dtype))
        flops = terms["pairs"] * FLOPS_D2["binned_sweep"] + terms["under"] * FLOPS_SPLINE
        b5 = bound(nbytes(*args[:4], out5) + nbytes(*(t for t in tables[1:] if t is not None)),
                   flops)
        nq = max(terms["queries"], 1)
        log(f"  K5 f32 {name}: kernel {ms5:.3f} ms, plain {pms5:.3f} ms; bound {b5[0]:.4f} ms "
            f"({b5[1]}): "
            f"{ms5 / b5[0]:.1f}x the bound; largest relative gap to the f64 plain version "
            f"{gap:.3e}")
        log(f"  K5 work: {terms['queries']} queries, {terms['pairs'] / nq:.2f} candidate "
            f"pairs and {terms['under'] / nq:.2f} within the support per particle")
        if entry is None:
            entry = dict(name="binned_sweep", route="cuda",
                         source="splashsurf_tpu_torch/csrc/binned_sweep.cu", replaces=None,
                         max_abs_err=err5, ms=ms5, plain_ms=pms5, bound_ms=b5[0],
                         bound_by=b5[1], library_ms=None, rel_gap_f64=gap, shape=name)
        del want, want64, out5, tables, args, cl
    f64 = frames["2M dam frame 4"].double()
    lo, hi = torch.aminmax(f64, dim=0)
    grid = N.BinGrid.for_domain(lo.cpu().numpy(), hi.cpu().numpy(), h)
    cl = N.build_cell_list(f64, grid)
    tables = N.binned_sweep_inputs(grid, cl, N.bin_stats_ex(cl)[1])
    compare("K5 f64 2M dam frame 4",
            sk.binned_sweep_cuda(*cl.sorted_positions, *tables, 16, grid.dims, h),
            sk.binned_sweep_plain(*cl.sorted_positions, *tables, 16, grid.dims, h), F64_TOL)
    del frames, f64, cl, tables

    # the dense route: one K5 launch per binned density pass
    scenes, cfg, _ = benchmark_dam_break()
    base = scenes.base_positions(cfg, 1, dev)
    N.reset_geoslot_hysteresis()
    clear_plans()
    before = dict(SPECULATION_STATS)
    reset_launches(sk)
    profiling.record_spans(True, dev)
    frame_s = []
    try:
        for k in range(1, 5):
            f = benchmark_motion(base, k).cpu().numpy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = pt.reconstruct_surface(f, params)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            if N.LAST_GATE["kind"] not in ("binned", "binned8"):
                raise AssertionError(f"sheared frame {k} took {N.LAST_GATE['kind']} densities")
            check_closed(pt, f"sheared 13.2M frame {k}", rec.mesh)
        spans = profiling.span_totals()
    finally:
        profiling.record_spans(False)
    passes = spans["binned sweep"]["count"]
    misses = stats_delta(before).get("density_miss", 0)
    if sk.binned_sweep_cuda.launches != passes or passes != 4 + misses:
        raise AssertionError(f"K5 launched {sk.binned_sweep_cuda.launches} times for {passes} "
                             f"binned passes of 4 frames ({misses} density misses)")
    del base
    log(f"  4 sheared 13.2M frames as numpy: K5 launched {passes} times, once per density pass "
        f"({misses} density misses); frame seconds {[round(s, 4) for s in frame_s]}; "
        f"'binned sweep' {spans['binned sweep']['device_s'] / passes * 1e3:.3f} ms a pass, "
        f"'compute particle densities' "
        f"{spans['compute particle densities']['device_s'] / 4 * 1e3:.3f} ms a frame")
    entry["launches"] = passes
    kernels["binned_sweep"] = entry


def raster_bits_differ(got, want):
    """Entries of the slot rasters ``got`` and ``want`` (``slot_raster_cuda``
    results) whose bits differ, and the particles whose overflow flag
    differs."""
    bits = lambda t: t.cpu().view(torch.int32 if t.element_size() == 4 else torch.int64)
    rasters = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(got[0], want[0]))
    return rasters, int((got[1].cpu() != want[1].cpu()).sum())


def phase_k6(pt, dev, pts, params, kernels, ident):
    """Phase 25: K6 against its plain version on the benchmark's sheared
    13.2M frame, timed beside its bound, bit for bit against the plain
    version on the host; the meta and f64 on the 2M frame; then the dense
    route's frames launching it once per raster run."""
    from splashsurf_tpu_torch import kernels as tk
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import profiling
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.reconstruction import _bucket_grid

    h, m = params.compact_support_radius, params.particle_rest_mass
    log(f"phase 25: K6 (slot raster) ({ident})")
    for line in ptxas_report(sk, "slot_raster.cu", ("slot_",)):
        log("  ptxas " + line)
    frames = {"13.2M dam frame 4": benchmark_dam_frame(4, dev), "2M dam break": pts}
    entry = None
    for name, f in frames.items():
        grid = _bucket_grid(pt.grid_for_reconstruction(f, RADIUS, h, params.cube_size))
        pad = pt.kernel_extents(h, grid.cell_size).half_supported_cells + 1
        N.reset_geoslot_hysteresis()
        values = tk.rounded(m, f.dtype) / N.compute_particle_densities(f, h, m)
        k6 = lambda: sk.slot_raster_cuda(f, values, grid, 2, pad)
        plain = lambda: sk.slot_raster_plain(f, values, grid, 2, pad)
        got = k6()
        torch.cuda.synchronize()
        host = sk.slot_raster_plain(f.cpu(), values.cpu(), grid, 2, pad)
        if raster_bits_differ(got, host) != (0, 0):
            raise AssertionError(f"K6 {name}: differs from the plain version on the host: "
                                 f"{raster_bits_differ(got, host)} (entries, overflow flags)")
        card = raster_bits_differ(got, plain())
        ms6, pms6 = cuda_ms(k6, 10), cuda_ms(plain, 5)
        S, Xp, Yp, Zp = got[0][0].shape
        n = f.shape[0]
        # the rasters written once, positions and weights read once, the S
        # claim tables of 4 bytes a cell, the overflow mask
        n_bytes = nbytes(*got[0]) + nbytes(f, values) + S * Xp * grid.n_cells[1] * \
            grid.n_cells[2] * 4 + n
        b6 = bound(n_bytes, 0)
        log(f"  K6 f32 {name}: {n} particles, rasters {(S, Xp, Yp, Zp)}, "
            f"{int(got[1].sum())} overflow; kernel {ms6:.3f} ms, plain {pms6:.3f} ms; bound "
            f"{b6[0]:.4f} ms ({b6[1]}, {n_bytes / 1e9:.3f} GB): {ms6 / b6[0]:.1f}x the bound; "
            f"bit-equal to the plain version on the host; against the plain version on the "
            f"card {card[0]} raster entries and {card[1]} overflow flags differ")
        if entry is None:
            entry = dict(name="slot_raster", route="cuda",
                         source="splashsurf_tpu_torch/csrc/slot_raster.cu", replaces=None,
                         max_abs_err=0.0, ms=ms6, plain_ms=pms6, bound_ms=b6[0],
                         bound_by=b6[1], library_ms=None, shape=name,
                         differs_from_card_plain=card)
        del got, host, values
    grid = _bucket_grid(pt.grid_for_reconstruction(pts, RADIUS, h, params.cube_size))
    pad = pt.kernel_extents(h, grid.cell_size).half_supported_cells + 1
    for label, p, meta in (("meta", pts, True), ("f64", pts.double(), False)):
        v = torch.full_like(p[:, 0], 1e-3)
        got = sk.slot_raster_cuda(p, v, grid, 2, pad, with_meta=meta)
        want = sk.slot_raster_plain(p.cpu(), v.cpu(), grid, 2, pad, with_meta=meta)
        same = raster_bits_differ(got, want) == (0, 0) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got[2] or (), want[2] or ()))
        if not same:
            raise AssertionError(f"K6 {label} 2M dam break: differs from the plain version")
        log(f"  K6 {label} 2M dam break: bit-equal to the plain version on the host")
    del frames

    # the dense route: one K6 launch per raster run ('dense raster' spans)
    scenes, cfg, _ = benchmark_dam_break()
    base = scenes.base_positions(cfg, 1, dev)
    N.reset_geoslot_hysteresis()
    clear_plans()
    before = dict(SPECULATION_STATS)
    reset_launches(sk)
    profiling.record_spans(True, dev)
    try:
        for k in range(1, 5):
            rec = pt.reconstruct_surface(benchmark_motion(base, k).cpu().numpy(), params)
            check_closed(pt, f"sheared 13.2M frame {k}", rec.mesh)
        spans = profiling.span_totals()
    finally:
        profiling.record_spans(False)
    runs = spans["dense raster"]["count"]
    if sk.slot_raster_cuda.launches != runs or runs < 4:
        raise AssertionError(f"K6 launched {sk.slot_raster_cuda.launches} times for {runs} "
                             f"raster runs of 4 frames")
    del base
    log(f"  4 sheared 13.2M frames as numpy: K6 launched {runs} times, once per raster run "
        f"({stats_delta(before)}); 'dense raster' "
        f"{spans['dense raster']['device_s'] / runs * 1e3:.3f} ms a run")
    entry["launches"] = runs
    kernels["slot_raster"] = entry


def phase_k4(pt, dev, pts, grid, hsc, params, kernels):
    """Phase 9: K4 against its plain version on the meta rasters of the 2M
    dam break (f32, timed with its mask pre-pass) and of a 20K dam break in
    f64, on occupied query slots; the kernel writes exactly 0 on the empty
    ones. Then edge rasters in f32 and f64."""
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    h = params.compact_support_radius

    def inputs(p, g):
        fracs, n_over, _ = gs.rasterize_global(p, None, g, 2, hsc, with_meta=True)
        args = (g.cell_size, h, math.ceil(h / g.cell_size - 1e-9), h / g.cell_size, hsc + 1,
                g.n_cells)
        return fracs, args, n_over

    def check(name, fracs, args, tol):
        occ = fracs[0][(slice(None),) + tuple(slice(args[4], args[4] + n) for n in args[5])] < 1e14
        out = sk.pair_sweep_cuda(*fracs, *args)
        err = compare(name, out, sk.pair_sweep_plain(*fracs, *args), tol, occ)
        if bool((out[~occ] != 0).any()):
            raise AssertionError(f"{name}: a nonzero sum on an empty query slot")
        return out, err

    fracs, args, n_over = inputs(pts, grid)
    reach, pad = args[2], args[4]
    n_runs = len(sk.pair_runs(reach, args[3]))
    log(f"phase 9: K4 on rasters {tuple(fracs[0].shape)} ({n_over} overflow particles), "
        f"fan {len(sk.pair_cell_offsets(reach, args[3]))} offsets in {n_runs} runs, reach {reach}")
    for line in ptxas_report(sk, "pair_sweep.cu", ("pair_sweep_tiles",)):
        log("  ptxas " + line)
    log_block_geometry(sk, "pair_sweep", n_runs, reach)
    masks = check_masks(sk, "K4 2M rasters", fracs[0], fractions=True)
    k4_occupancy_report(sk, fracs[0], masks, reach, pad, args[5])
    del masks
    out4, err4 = check("K4 f32", fracs, args, F32_TOL)
    ms4 = cuda_ms(lambda: sk.pair_sweep_cuda(*fracs, *args), 10)
    pms4 = cuda_ms(lambda: sk.pair_sweep_plain(*fracs, *args), 3)
    pre4 = cuda_ms(lambda: sk.occupancy_masks_cuda(fracs[0], fractions=True), 10)
    terms = pair_terms(fracs, args[0], *args[2:], sk.support_cut2(h, fracs[0].dtype))
    b4, b4_old = pair_bounds("pair_sweep", needed_bytes(fracs, out4), nbytes(*fracs, out4), terms)
    log_bounds("K4 f32", ms4, pre4, pms4, b4, b4_old, terms)
    del fracs, out4
    small = torch.as_tensor(bench.make_dam_break(20_000, RADIUS), device=dev).double()
    sgrid = pt.grid_for_reconstruction(small, RADIUS, h, params.cube_size)
    f64, args64, _ = inputs(small, sgrid)
    check("K4 f64", f64, args64, F64_TOL)
    # edge rasters: cells (13, 11, 45), none a multiple of the 4 x 8 x 32 tile
    n_edge = (13, 11, 45)
    cs = grid.cell_size
    eargs = (cs, h, reach, h / cs, pad, n_edge)
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for name, r in pair_edge_rasters(n_edge, pad, dt, dev, cs, h, seed=19):
            check_masks(sk, f"K4 {dt} {name}", r[0], fractions=True)
            check(f"K4 {dt} {name} {tuple(r[0].shape)}", r, eargs, tol)
    kernels["pair_sweep"] = dict(
        name="pair_sweep", route="cuda",
        source="splashsurf_tpu_torch/csrc/pair_sweep.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:354",
        max_abs_err=err4, ms=ms4, plain_ms=pms4, bound_ms=b4[0], bound_by=b4[1],
        library_ms=None,
    )


def dense_stage_split(pts, params, grid, hsc, cellraster: bool, reps: int = 3):
    """Seconds of each stage of one dense frame, the device synchronised at
    each stage boundary, median over ``reps`` frames: the legacy densities
    (densities, rasterize, sweep, MC, pull) or the cell-raster ones
    (rasterize with meta, K4 + fv, sweep, MC, pull)."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.ops import global_sweep as gs

    h, m = params.compact_support_radius, params.particle_rest_mass
    runs = []
    for _ in range(reps):
        t = {}
        torch.cuda.synchronize()
        t0 = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            t[name] = now - t0[0]
            t0[0] = now

        if cellraster:
            fracs, _, meta = gs.rasterize_global(pts, None, grid, 2, hsc, with_meta=True)
            lap("rasterize")
            fv, _ = gs.density_weights_from_rasters(
                *fracs, *meta, m, h, grid, hsc, math.ceil(h / grid.cell_size - 1e-9),
                h / grid.cell_size,
            )
            lap("K4 + fv")
            none = pts.new_empty(0)
            ls = gs.sweep_global(fracs + (fv,), (none,) * 4, grid, h, hsc)
        else:
            rho = N.compute_particle_densities(pts, h, m)
            lap("densities")
            rasters, overflow = gs.rasterize_global(pts, m / rho, grid, 2, hsc)
            lap("rasterize")
            ls = gs.sweep_global(rasters, overflow, grid, h, hsc)
        lap("sweep")
        verts, tris = gs.mc_global_cells(ls, grid, params.iso_surface_threshold)
        lap("marching cubes")
        gs.PendingPull(lambda v, t: (v, t), [verts, tris]).resolve()
        lap("pull")
        runs.append(t)
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def rel_err(rho, truth):
    return float(((rho.double() - truth).abs() / truth).max())


def compare_legacy(pt, frame, params, cell):
    """Frame 1 (the first on the cell-raster densities, ``cell``) against
    the legacy densities (switch "0").

    In f64 the two agree within rho rtol 1e-5 (the reference's own bar
    between them), with equal counts and vertices within 1e-4. In f32 the
    dam break's coordinates (up to 6 m, 4.8e-7 m apart) hold pair distances
    of 0.022 m only to about 2e-5, and the two formulations round their cell
    and bin corners differently, so there each is held to the f64 densities
    of the same positions: the cell-raster ones within 1e-5 or twice the
    legacy ones' error, whichever is larger; and the meshes to vertices
    within 1e-4 of one another, both ways (a grid point whose level set
    lies within that rounding of the threshold may flip, changing the
    counts by a few, not the surface)."""
    from scipy.spatial import cKDTree

    from splashsurf_tpu_torch import neighbors as N

    os.environ[CELLRASTER] = "0"
    legacy = pt.reconstruct_surface(frame, params)
    if N.LAST_GATE.get("kind") == "cellraster":
        raise AssertionError("the switch at 0 still took the cell-raster densities")
    kind = N.LAST_GATE["kind"]
    p64, f64 = params.try_convert("float64"), frame.double()
    truth = pt.reconstruct_surface(f64, p64)
    os.environ[CELLRASTER] = "1"
    cell64 = pt.reconstruct_surface(f64, p64)
    if N.LAST_GATE.get("kind") != "cellraster":
        raise AssertionError("the f64 frame did not take the cell-raster densities")
    torch.testing.assert_close(cell64.particle_densities, truth.particle_densities,
                               rtol=1e-5, atol=0)
    log(f"  frame 1 f64, cell-raster / legacy ({kind}) densities: rho max relative "
        f"difference {rel_err(cell64.particle_densities, truth.particle_densities):.3e}")
    check_same_mesh("frame 1 f64, cell-raster / legacy", cell64.mesh, truth.mesh, ordered=True)
    rho64 = truth.particle_densities
    e_cell = rel_err(cell.particle_densities, rho64)
    e_leg = rel_err(legacy.particle_densities, rho64)
    log(f"  frame 1 f32, rho max relative error against the f64 densities: cell-raster "
        f"{e_cell:.3e}, legacy {e_leg:.3e}; between them "
        f"{rel_err(cell.particle_densities, legacy.particle_densities.double()):.3e}")
    if e_cell > max(1e-5, 2 * e_leg):
        raise AssertionError(f"cell-raster densities off by {e_cell:.3e} (legacy {e_leg:.3e})")
    check_same_mesh("frame 1 f32, cell-raster / legacy", cell.mesh, legacy.mesh, ordered=False,
                    tree=cKDTree, same_counts=False)


def timed_sequence(gen):
    """Consume a sequence of results, each resolved to a host mesh when it
    is yielded: the results and the host seconds between yields (the first
    from the start)."""
    out, gaps = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for rec in gen:
        now = time.perf_counter()
        gaps.append(now - t)
        t = now
        out.append(rec)
    return out, gaps


def phase_sequence(pt, pts, params, kernels, ident):
    """Phase 10: the sequence entry point with the cell-raster densities on
    the 2M dam break, the main path of K4."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import plans
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.reconstruction import _bucket_grid

    h = params.compact_support_radius
    n = pts.shape[0]
    frames = [pts + (k + 1) * 1e-4 * RADIUS for k in range(N_FRAMES)]
    grids = [_bucket_grid(pt.grid_for_reconstruction(f, RADIUS, h, params.cube_size))
             for f in frames]
    hsc = pt.kernel_extents(h, grids[0].cell_size).half_supported_cells
    over = [gs.rasterize_global(f, None, g, 2, hsc, with_meta=True)[1]
            for f, g in zip(frames, grids)]
    log(f"phase 10: reconstruct_sequence, {N_FRAMES} frames of {n} particles, "
        f"{CELLRASTER}=1; raster overflow per frame {over}")
    saved = {k: os.environ.get(k) for k in (CELLRASTER, "SPLASHSURF_TPU_PIPELINE")}
    try:
        os.environ[CELLRASTER] = "1"
        list(pt.reconstruct_sequence(frames[:2], params))  # warm-up, not counted
        clear_plans()  # the sequence's first frame plans, as a user's does
        reset_launches(sk)
        record = []

        def recording():
            for f, g in zip(frames, grids):
                # the reference's condition (global_pipeline.py:383-389)
                planned = plans.cellraster_ready(g.n_points, n, str(f.dtype))
                k4, k2 = sk.pair_sweep_cuda.launches, sk.density_sweep_cuda.launches
                yield f
                record.append((planned, N.LAST_GATE.get("kind"),
                               sk.pair_sweep_cuda.launches - k4,
                               sk.density_sweep_cuda.launches - k2))

        seq, gaps_pipe = timed_sequence(pt.reconstruct_sequence(recording(), params))
        launches = sk.pair_sweep_cuda.launches
        masks = check_mask_launches(sk, sk.sweep_global_cuda.launches + launches)
        took = 0
        for i, ((planned, kind, k4, k2), n_over) in enumerate(zip(record, over)):
            want = ("cellraster", 1, 0) if planned else (kind, 0, 1)
            if n_over == 0 and ((kind, k4, k2) != want or (kind == "cellraster") != planned):
                raise AssertionError(
                    f"frame {i} (plans for the cell-raster densities: {planned}) took "
                    f"{kind} with K4, K2 launches {k4}, {k2}"
                )
            took += kind == "cellraster"
        if record[0][0] or took == 0:
            raise AssertionError("the first frame was not the planning frame, or no frame "
                                 "took the cell-raster densities")
        kernels["pair_sweep"]["launches"] = launches
        for i, rec in enumerate(seq):
            bad = pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles)
            if bad is not None or rec.mesh.num_triangles == 0:
                raise AssertionError(f"frame {i}: mesh not closed/manifold or empty: {bad}")

        os.environ["SPLASHSURF_TPU_PIPELINE"] = "0"
        clear_plans()  # the same plans, frame by frame
        single, gaps_single = timed_sequence(pt.reconstruct_sequence(frames, params))
        for i, (a, b) in enumerate(zip(seq, single)):
            check_same_mesh(f"frame {i}, sequence / frame at a time", a.mesh, b.mesh, ordered=True)

        compare_legacy(pt, frames[1], params, seq[1])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"  {took} of {N_FRAMES} frames took the cell-raster densities; K4 launches {launches}, "
        f"mask pre-pass launches {masks} (K1 and K4); "
        f"mesh {seq[0].mesh.num_vertices} vertices, {seq[0].mesh.num_triangles} triangles, closed")
    for name, gaps in (("pipelined", gaps_pipe), ("frame at a time", gaps_single)):
        # the sequence dispatches two frames before its first yield and
        # none before its last (in both modes): the median of the inner
        # gaps is the steady per-frame time
        per = statistics.median(gaps[1:-1])
        log(f"  {name}: seconds between yields {[round(g, 4) for g in gaps]}; mean "
            f"{sum(gaps) / len(gaps):.4f}, steady median {per:.4f} s per frame = "
            f"{n / per / 1e6:.3f} Mparticles/s ({ident})")
    for name, cr in (("cell-raster", True), ("legacy", False)):
        split = dense_stage_split(frames[0], params, grids[0], hsc, cr)
        log(f"  stage seconds, {name} densities (median of 3): "
            + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
            + f"; sum {sum(split.values()):.5f}")


def phase_cli(pt, pts_np, ident):
    """Phase 11: the user's command on the 2M dam break, in-process, so that
    the kernels' launch counts can be read."""
    import tempfile

    from splashsurf_tpu_torch import native, postprocess, profiling
    from splashsurf_tpu_torch.cli import run_splashsurf
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native half-edge engine did not build or load")
    log(f"phase 11: the reconstruct CLI on {len(pts_np)} particles; native half-edge engine "
        f"{native._LIB.relative_to(native._LIB.parents[2])} ready in {time.perf_counter() - t0:.2f} s")
    vel = np.random.default_rng(0).standard_normal(pts_np.shape).astype(np.float32)
    sizes = {}

    def recording(name, fn):
        def wrapped(mesh, *args, **kw):
            out = fn(mesh, *args, **kw)
            sizes[name] = (mesh.num_vertices, mesh.num_triangles,
                           out[0].num_vertices, out[0].num_triangles)
            return out
        return wrapped

    saved = (postprocess.marching_cubes_cleanup, postprocess.decimation)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "fluid.vtk"), os.path.join(tmp, "surface.vtk")
        t0 = time.perf_counter()
        pt.io.write_particles(src, pts_np, {"velocity": vel})
        write_s = time.perf_counter() - t0
        argv = ["reconstruct", src, *CLI_FLAGS, "-o", dst]
        log(f"  python -m splashsurf_tpu_torch {' '.join(argv)}")
        postprocess.marching_cubes_cleanup = recording("cleanup", saved[0])
        postprocess.decimation = recording("decimation", saved[1])
        runs = []
        try:
            # the first run is the main path (its launches are read); the
            # second, warm one shows which seconds are first-use costs
            for _ in range(2):
                profiling.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches(sk)
                t0 = time.perf_counter()
                rc = run_splashsurf(argv)
                runs.append(dict(
                    rc=rc, s=time.perf_counter() - t0, tree=profiling.write_to_string(),
                    peak=torch.cuda.max_memory_allocated(),
                    launches={"sweep_global": sk.sweep_global_cuda.launches,
                              "density_sweep": sk.density_sweep_cuda.launches},
                ))
                if rc != 0:
                    break
                # each run's pre-passes, read before the next run resets them
                runs[-1]["launches"]["occupancy_masks"] = check_mask_launches(
                    sk, sk.sweep_global_cuda.launches)
        finally:
            postprocess.marching_cubes_cleanup, postprocess.decimation = saved
        rc, cli_s, launches, peak = (runs[0][k] for k in ("rc", "s", "launches", "peak"))
        if rc != 0:
            raise AssertionError(f"the CLI exited {rc}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was not launched by the CLI path")
        if set(sizes) != {"cleanup", "decimation"}:
            raise AssertionError(f"cleanup and decimation did not both run: {sorted(sizes)}")
        in_mb, out_mb = os.path.getsize(src) / 1e6, os.path.getsize(dst) / 1e6
        t0 = time.perf_counter()
        mesh = pt.io.mesh_from_file(dst)
        read_s = time.perf_counter() - t0
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None or mesh.num_triangles == 0 or not np.isfinite(mesh.vertices).all():
        raise AssertionError(f"the CLI's mesh is not closed/manifold, empty or not finite: {bad}")
    if (mesh.num_vertices, mesh.num_triangles) != sizes["decimation"][2:]:
        raise AssertionError(f"mesh read back {mesh.num_vertices}/{mesh.num_triangles}, "
                             f"decimation gave {sizes['decimation'][2:]}")
    log(f"  rc 0 in {cli_s:.3f} s; launches {launches} (K1, K2, K1's mask pre-pass); mesh read back closed and "
        f"manifold: {mesh.num_vertices} vertices, {mesh.num_triangles} triangles")
    for name in ("cleanup", "decimation"):
        v0, t0_, v1, t1 = sizes[name]
        log(f"  {name}: {v0} vertices, {t0_} triangles -> {v1} vertices, {t1} triangles")
    log(f"  file IO outside the CLI: particles written ({in_mb:.1f} MB) in {write_s:.3f} s, "
        f"mesh read back ({out_mb:.1f} MB) in {read_s:.3f} s")
    log(f"  peak device memory {peak} bytes ({peak / 1e9:.3f} GB); {ident}")
    for name, run in zip(("first", "second (warm)"), runs):
        log(f"  profile tree of the {name} CLI run, {run['s']:.3f} s in all, rc {run['rc']}, "
            f"launches {run['launches']} ({ident}):")
        for line in run["tree"].splitlines():
            log("    " + line)


def phase_pipeline_cross(pt, dev):
    """Phase 12: the pipeline in f64 and its device ops in f32, CPU against
    CUDA."""
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch import postprocess as pp
    from splashsurf_tpu_torch.sph_interpolation import (
        SphInterpolator, compute_weighted_neighbor_counts, smooth_step,
    )

    pts = bench.make_dam_break(N_PIPE, RADIUS, seed=7)
    vel = np.random.default_rng(1).standard_normal(pts.shape)
    post = pt.PostprocessingParameters(
        mesh_cleanup=True, decimate_barnacles=True, mesh_smoothing_iters=25,
        mesh_smoothing_weights=True, compute_normals=True, sph_normals=True,
        normals_smoothing_iters=10, interpolate_attributes=["velocity"],
        check_mesh_closed=True, check_mesh_manifold=True,
    )
    p64 = pt.Parameters.new_relative(RADIUS, 4.0, 1.5, dtype="float64")
    log(f"phase 12: reconstruction_pipeline, {len(pts)} particles, f64, the phase 11 chain, "
        "CPU input vs CUDA input")
    out, secs = {}, {}
    for name, kw in (("cpu", dict(device="cpu")), ("cuda", dict(device=dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = pt.reconstruction_pipeline(pts, p64, post, {"velocity": vel}, **kw).tri_mesh
        secs[name] = time.perf_counter() - t0
    a, b = out["cpu"], out["cuda"]
    if not np.array_equal(a.mesh.triangles, b.mesh.triangles):
        raise AssertionError("f64 pipeline: CPU and CUDA triangle lists differ")
    errs = {"vertices": compare("f64 pipeline vertices", torch.as_tensor(b.mesh.vertices),
                                torch.as_tensor(a.mesh.vertices), PIPE_TOL)}
    for x, y in zip(a.point_attributes, b.point_attributes):
        errs[x.name] = compare(f"f64 pipeline {x.name}", torch.as_tensor(y.data),
                               torch.as_tensor(x.data), PIPE_TOL)
    log(f"  triangle lists equal ({b.mesh.num_triangles}); max abs differences {errs}; "
        f"seconds cpu {secs['cpu']:.3f}, cuda {secs['cuda']:.3f}")

    p32 = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    rec = pt.reconstruct_surface(pts.astype(np.float32), p32, device="cpu")
    mesh, rho = rec.mesh, rec.particle_densities
    h = p32.compact_support_radius
    weights = None
    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        pos = torch.as_tensor(pts.astype(np.float32), device=d)
        interp = SphInterpolator(pos, rho.to(d), p32.particle_rest_mass, h)
        wnn = compute_weighted_neighbor_counts(pos, h)
        if weights is None:  # the same weights on both sides: the op alone is compared
            weights = smooth_step(np.minimum(np.maximum(
                interp.interpolate_scalar_quantity(wnn, mesh.vertices, True), 0.0) / 13.0, 1.0)
            ).astype(np.float32)
        normals = interp.interpolate_normals(mesh.vertices)
        res[name] = {
            "weighted neighbour counts": wnn,
            "interpolated wnn": interp.interpolate_scalar_quantity(wnn, mesh.vertices, True),
            "SPH normals": normals,
            "interpolated velocity": interp.interpolate_vector_quantity(
                vel.astype(np.float32), mesh.vertices, True),
            "smoothed vertices": pp.laplacian_smoothing(
                mesh.vertices, mesh.triangles, 25, 1.0, weights, device=d),
            "smoothed normals": pp.laplacian_smoothing_normals(
                res["cpu"]["SPH normals"] if name == "cuda" else normals,
                mesh.triangles, mesh.num_vertices, 10, device=d),
        }
    errs, failed = {}, []
    for key, want in res["cpu"].items():
        got = res["cuda"][key]
        errs[key] = float(np.abs(got - want).max())
        if got.dtype != np.float32 or not np.allclose(got, want, **PIPE_TOL):
            failed.append(key)
    log(f"  f32 ops on a {mesh.num_vertices}-vertex host mesh, CUDA vs CPU, max abs "
        f"differences {errs}")
    if failed:
        raise AssertionError(f"f32 ops differ beyond {PIPE_TOL}: {failed}")


def timed_frames(pt, pts, params, n):
    """``n`` frames of ``reconstruct_surface``, each timed on the host clock
    from call to host mesh, the device synchronised: (last result, seconds)."""
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(pts, params)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return rec, secs


def slab_run(pt, pts, params, sk):
    """One slab-route frame from zeroed launch counts: (result, a copy of
    ``slab_sweep.LAST_RUN``, K1 launches); each K1 launch built its masks."""
    from splashsurf_tpu_torch.ops import slab_sweep as SL

    reset_launches(sk)
    SL.LAST_RUN.clear()
    rec = pt.reconstruct_surface(pts, params)
    torch.cuda.synchronize()
    k1 = sk.sweep_global_cuda.launches
    check_mask_launches(sk, k1)
    run = dict(SL.LAST_RUN)
    run["stage_s"] = dict(run.get("stage_s", {}))
    if rec.subdomain_grid is not None or not run.get("slabbed"):
        raise AssertionError("the frame did not take the slab route")
    if k1 != run["n_slabs"]:
        raise AssertionError(f"{k1} K1 launches for {run['n_slabs']} slabs")
    return rec, run, k1


def check_closed(pt, name, mesh):
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None or mesh.num_triangles == 0 or not np.isfinite(mesh.vertices).all():
        raise AssertionError(f"{name}: mesh not closed/manifold, empty or not finite: {bad}")


def phase_slab(pt, dev, canyon, sub_mesh, pts_np, dense_mesh, ident):
    """Phase 13: the slab route, which default parameters take past the
    dense gate: the 8M canyon against phase 7's subdomain mesh, the 2M dam
    break through 7 slabs against phase 4's dense mesh, and K1 against its
    plain version on the canyon's fullest and last slab windows and on
    8-cell windows."""
    log("phase 13: the slab route")
    counts = slab_canyon(pt, canyon, sub_mesh, ident, expect=(8, 340))
    pts = torch.as_tensor(pts_np, device=dev)
    slab_dam(pt, pts, dense_mesh, ident, expect=(7, 63))
    k1_windows(pt, pts)
    return counts


def slab_canyon(pt, canyon, sub_mesh, ident, expect):
    """The canyon with default parameters: ``expect`` = (slabs, width).
    Returns the mesh's (vertices, triangles)."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.reconstruction import _bucket_grid, choose_route

    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    n = canyon.shape[0]
    grid = _bucket_grid(pt.grid_for_reconstruction(
        canyon, RADIUS, params.compact_support_radius, params.cube_size))
    log(f"  reconstruct_surface, {n}-particle canyon, default parameters: grid "
        f"{grid.n_cells} ({grid.total_cells} cells), route {choose_route(params, grid)}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, run, k1 = slab_run(pt, canyon, params, sk)
    cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if (run["n_slabs"], run["slab_w"]) != expect:
        raise AssertionError(f"{run['n_slabs']} slabs of {run['slab_w']} cells, not {expect}")
    mesh = rec.mesh
    check_closed(pt, "slab canyon", mesh)
    dv, dt = mesh.num_vertices - sub_mesh.num_vertices, mesh.num_triangles - sub_mesh.num_triangles
    rel = max(abs(dv) / sub_mesh.num_vertices, abs(dt) / sub_mesh.num_triangles)
    log(f"  {run['n_slabs']} slabs of {run['slab_w']} cells ({run['slab_cells']} cells each), "
        f"particles per slab {run['rows']}; K1 launches {k1}, each after its mask pre-pass; "
        f"densities {N.LAST_GATE.get('kind')}")
    log(f"  mesh {mesh.num_vertices} vertices, {mesh.num_triangles} triangles, closed; "
        f"the subdomain route's (phase 7) {sub_mesh.num_vertices}, {sub_mesh.num_triangles}: "
        f"differences {dv} vertices, {dt} triangles, {rel:.3e} relative")
    if rel > 1e-4:
        raise AssertionError(f"slab and subdomain canyon counts differ by {rel:.3e} relative")
    counts = (mesh.num_vertices, mesh.num_triangles)
    del rec, mesh
    _, warm_s = timed_frames(pt, canyon, params, 3)
    warm = statistics.median(warm_s)
    log("  stage seconds (cold frame): "
        + ", ".join(f"{k} {v:.4f}" for k, v in run["stage_s"].items()))
    log(f"  frame seconds: cold {cold:.4f}, warm {[round(x, 4) for x in warm_s]}; warm median "
        f"{warm:.4f} s = {n / warm / 1e6:.3f} Mparticles/s; peak device memory {peak} bytes "
        f"({peak / 1e9:.3f} GB, cold frame) ({ident})")
    # K1 against its plain version at the shapes this route gave it: the
    # fullest slab's window and the ragged last slab's
    values, _, hsc = slab_values(pt, canyon, params)
    W, rows = run["slab_w"], run["rows"]
    full = int(np.argmax(rows))
    last = run["n_slabs"] - 1
    for s, name in ((full, f"the canyon's fullest slab ({rows[full]} particles)"),
                    (last, f"the canyon's ragged last slab ({grid.n_cells[0] - last * W} "
                           f"of {W} cells in the grid)")):
        k1_window(canyon, values, grid, hsc, params.compact_support_radius, W, s * W, name)
    return counts


def slab_dam(pt, pts, dense_mesh, ident, expect, cells=1_000_000):
    """The dam break with the dense gate and the slab budget at ``cells``,
    against its dense mesh: ``expect`` = (slabs, width)."""
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    env = {"SPLASHSURF_TPU_GLOBAL_DENSE_MAX_CELLS": str(cells),
           "SPLASHSURF_TPU_SLAB_CELLS_BUDGET": str(cells)}
    saved = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        rec, run, k1 = slab_run(pt, pts, params, sk)
        _, warm_s = timed_frames(pt, pts, params, 3)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (run["n_slabs"], run["slab_w"]) != expect:
        raise AssertionError(f"dam break: {run['n_slabs']} slabs of {run['slab_w']}, not {expect}")
    mesh = rec.mesh
    check_closed(pt, "slab dam break", mesh)
    if not np.array_equal(mesh.triangles, dense_mesh.triangles):
        raise AssertionError("dam break: the slab route's triangle list is not the dense route's")
    vdiff = float(np.abs(mesh.vertices - dense_mesh.vertices).max())
    if vdiff > 1e-6:
        raise AssertionError(f"dam break: slab and dense vertices differ by {vdiff}")
    log(f"  {pts.shape[0]}-particle dam break, dense gate and slab budget at {cells} cells: "
        f"{run['n_slabs']} slabs of {run['slab_w']} cells, K1 launches {k1}; triangle list "
        f"equal to the dense route's ({mesh.num_triangles}), max vertex diff {vdiff:.3e}, "
        f"vertices bit-equal: {bool(np.array_equal(mesh.vertices, dense_mesh.vertices))}")
    log(f"  stage seconds: " + ", ".join(f"{k} {v:.5f}" for k, v in run["stage_s"].items())
        + f"; warm frames {[round(x, 4) for x in warm_s]} s ({ident})")


def k1_window(pts, values, grid, hsc, h, W, x0, name):
    """K1 against its plain version on the slab window of ``W`` cells from
    global cell ``x0`` on, at the shapes the slab route gives it: the
    window's rasters (2, W + 2 pad, Yp, Zp), masks checked bit for bit,
    and its (W + 1, PY, PZ) points."""
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    rasters, overflow = gs.rasterize_global(pts, values, grid, 2, hsc, slab_ncx=W, slab_x0=x0)
    npts = (W + 1,) + grid.n_points[1:]
    check_masks(sk, f"K1 {W}-cell window, {name}", rasters[3])
    compare(f"K1 {W}-cell window at x0 = {x0}, {name}, rasters {tuple(rasters[0].shape)} -> "
            f"{npts}, {int(torch.count_nonzero(rasters[3]))} occupied slots, "
            f"{overflow[0].shape[0]} overflow",
            sk.sweep_global_cuda(*rasters, grid.cell_size, h, hsc, npts),
            sk.sweep_global_plain(*rasters, grid.cell_size, h, hsc, npts), F32_TOL)


def slab_values(pt, pts, params):
    """The slab route's weights m / rho of ``pts`` and its grid and hsc."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.reconstruction import _bucket_grid

    h = params.compact_support_radius
    grid = _bucket_grid(pt.grid_for_reconstruction(pts, RADIUS, h, params.cube_size))
    hsc = pt.kernel_extents(h, grid.cell_size).half_supported_cells
    rho = N.compute_particle_densities(pts, h, params.particle_rest_mass)
    return params.particle_rest_mass / rho, grid, hsc


def k1_windows(pt, pts):
    """K1 against its plain version on 8-cell slab windows of the dam
    break: inside the fluid, and the ragged last slab of a grid cut to end
    inside it (3 of the window's cells in the grid)."""
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    values, grid, hsc = slab_values(pt, pts, params)
    ncx, ncy, ncz = grid.n_cells
    cut = pt.UniformGrid(min=grid.min, cell_size=grid.cell_size, n_cells=(ncx // 2 + 3, ncy, ncz))
    for g, x0, name in ((grid, ncx // 2, "inside the fluid"),
                        (cut, cut.n_cells[0] - 3, f"ragged last slab of a {cut.n_cells} grid")):
        k1_window(pts, values, g, hsc, params.compact_support_radius, 8, x0, name)


def subdomain_frames(pt, pts, params, n):
    """``n`` frames of ``reconstruct_surface`` on the subdomain route:
    (last result, seconds of each frame, a copy of ``subdomains.LAST_RUN``
    after each frame, with "atomics": whether a sum of the frame ran with
    atomics, the overflow scatter of the splat or the binned densities'
    overflow correction past 8 particles in a bin)."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import subdomains as S

    secs, runs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(pts, params)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        run = dict(S.LAST_RUN)
        run["stage_s"] = dict(run["stage_s"])
        run["peak_bytes"] = dict(run.get("peak_bytes", {}))
        gate = N.LAST_GATE
        run["atomics"] = run["raster_overflow"] > 0 or (
            gate["kind"] == "binned8" and gate["max_occ"] > 8)
        runs.append(run)
        if rec.subdomain_grid is None:
            raise AssertionError("the frame did not take the subdomain route")
    return rec, secs, runs


def stage_line(run):
    return ", ".join(
        f"{k} {v:.4f} s / {run['peak_bytes'].get(k, 0) / 1e9:.3f} GB"
        for k, v in run["stage_s"].items()
    )


def check_streamed_mesh(name, mesh, resident, atomics):
    """The mesh (streamed or sharded) is the resident one: bit for bit when
    no sum ran with atomics (which reorder it from run to run), otherwise
    equal triangle lists and vertices within 1e-6. Returns the largest
    vertex difference."""
    same_t = mesh.triangles.shape == resident.triangles.shape and bool(
        (mesh.triangles == resident.triangles).all())
    same_v = mesh.vertices.shape == resident.vertices.shape
    vdiff = float(np.abs(mesh.vertices - resident.vertices).max()) if same_v else math.inf
    if not (same_t and (vdiff <= 1e-6 if atomics else vdiff == 0.0)):
        raise AssertionError(
            f"{name}: the mesh differs from the resident one: triangle lists equal "
            f"{same_t}, max vertex diff {vdiff} (atomics {atomics})")
    return vdiff


def phase_streaming(pt, canyon, resident_mesh, ident):
    """Phase 15: the streamed mode of the subdomain route on the 8M canyon
    against phase 7's resident mesh, and the auto gate on a 100K canyon."""
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch import subdomains as S
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    params = canyon_params(pt)
    n = canyon.shape[0]
    saved = {k: os.environ.get(k) for k in (S.STREAM_ENV, S.STREAM_BUDGET_ENV)}
    os.environ.pop(S.STREAM_BUDGET_ENV, None)
    S.STAGE_PEAKS = True
    try:
        log(f"phase 15: the streamed subdomain route, {n}-particle canyon, 64-cell subdomains")
        os.environ[S.STREAM_ENV] = "0"
        _, res_s, (res_run,) = subdomain_frames(pt, canyon, params, 1)
        log(f"  resident frame {res_s[0]:.4f} s; stage seconds / peak device memory: "
            + stage_line(res_run))
        os.environ[S.STREAM_ENV] = "1"
        reset_launches(sk)
        rec, secs, runs = subdomain_frames(pt, canyon, params, 3)
        launches = sk.splat_sweep_cuda.launches
        check_mask_launches(sk, launches)
        run = runs[-1]
        chunks = [r["splat_chunks"] for r in runs]
        if not all(r["streamed"] for r in runs):
            raise AssertionError("SPLASHSURF_TPU_STREAM=1 did not stream")
        if launches == 0 or launches != sum(chunks):
            raise AssertionError(f"{launches} K3 launches for {chunks} streamed chunks")
        mesh = rec.mesh
        check_closed(pt, "streamed canyon", mesh)
        over = run["raster_overflow"]
        atomics = run["atomics"] or res_run["atomics"]
        vdiff = check_streamed_mesh("the 8M canyon", mesh, resident_mesh, atomics)
        # K3 against its plain version at the streamed plan's fullest chunk
        rasters, sd, _, n_chunks = k3_chunk(pt, canyon, params, streamed=True)
        h, m, P = params.compact_support_radius, sd.margin_cells, sd.points_per_dim
        cs = sd.global_grid.cell_size
        compare(f"K3 f32, fullest of {n_chunks} streamed chunks {tuple(rasters[0].shape)}",
                sk.splat_sweep_cuda(*rasters, cs, h, m, m, P),
                sk.splat_sweep_plain(*rasters, cs, h, m, m, P), K3_F32_TOL)
        del rasters
        peak = max(run["peak_bytes"].values(), default=0)
        res_peak = max(res_run["peak_bytes"].values(), default=1)
        log(f"  B {run['B']}, raster overflow {over} pairs; shell table {run['shell_bytes']} "
            f"bytes in place of {run['ls_bytes']} resident; {run['splat_chunks']} chunks "
            f"(K3 launches {launches} in 3 frames, each after its mask pre-pass)")
        log(f"  mesh {mesh.num_vertices} vertices, {mesh.num_triangles} triangles, closed; "
            f"equal to phase 7's resident mesh ({'within 1e-6' if atomics else 'bit for bit'}"
            f": triangle lists equal, max vertex diff {vdiff:.3e})")
        for i, r in enumerate(runs):
            log(f"  streamed frame {i} ({'cold' if i == 0 else 'warm'}) {secs[i]:.4f} s; stage "
                "seconds / peak device memory: " + stage_line(r))
        warm = statistics.median(secs[1:])
        log(f"  frame seconds: resident {res_s[0]:.4f}, streamed cold {secs[0]:.4f}, warm "
            f"{[round(x, 4) for x in secs[1:]]}; warm median {warm:.4f} s = "
            f"{n / warm / 1e6:.3f} Mparticles/s, {warm / res_s[0]:.3f}x the resident frame; "
            f"peak device memory streamed {peak} bytes, resident {res_peak} bytes "
            f"({peak / res_peak:.3f}x) ({ident})")

        # the auto gate: default budget resident, a budget below the level sets streams
        cross = torch.as_tensor(bench.make_canyon(N_CROSS, RADIUS, seed=3), device=canyon.device)
        os.environ.pop(S.STREAM_ENV)
        stay, _, (r0,) = subdomain_frames(pt, cross, params, 1)
        os.environ[S.STREAM_BUDGET_ENV] = str(r0["ls_bytes"] - 1)
        reset_launches(sk)
        auto, _, (r1,) = subdomain_frames(pt, cross, params, 1)
        if r0["streamed"] or not r1["streamed"]:
            raise AssertionError(f"auto gate: streamed {r0['streamed']} under the default "
                                 f"budget, {r1['streamed']} under {r0['ls_bytes'] - 1} bytes")
        if sk.splat_sweep_cuda.launches != r1["splat_chunks"]:
            raise AssertionError("the auto-gated streamed frame did not launch K3 per chunk")
        atomics = r0["atomics"] or r1["atomics"]
        vdiff = check_streamed_mesh("the 100K canyon", auto.mesh, stay.mesh, atomics)
        log(f"  auto gate, {len(cross)}-particle canyon: {r0['ls_bytes']} bytes of level sets "
            f"resident under the default budget, streamed under {r0['ls_bytes'] - 1} "
            f"({r1['splat_chunks']} chunks, raster overflow {r1['raster_overflow']}, atomics "
            f"{atomics}); the same mesh, {auto.mesh.num_triangles} triangles, max vertex diff "
            f"{vdiff:.3e}")
    finally:
        S.STAGE_PEAKS = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dryrun_scene(pt):
    """The multi-device validation scene of the JAX package's dry run
    (``__graft_entry__.dryrun_scene``), rebuilt here with numpy: a jittered
    sheet and a dense clump on one corner, 8-cell subdomains, over 64
    occupied with uneven occupancy. Returns (points, parameters, grid)."""
    import dataclasses

    params = dataclasses.replace(
        pt.Parameters.new_relative(0.025, 4.0, 1.0),
        grid_decomposition=pt.GridDecompositionParameters(8, auto_disable=False),
    )
    r = params.particle_radius
    rng = np.random.default_rng(0)

    def block(nx, ny, nz, spacing, jitter):
        g = np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T.astype(np.float32)
        pts = g * np.float32(spacing)
        pts += rng.uniform(-jitter, jitter, pts.shape).astype(np.float32) * spacing
        return pts

    sheet = block(48, 4, 24, 2 * r, 0.2)
    clump = block(12, 12, 12, 1.6 * r, 0.3) + np.float32([4 * r, 4 * 2 * r, 4 * r])
    pts = np.concatenate([sheet, clump]).astype(np.float32)
    grid = pt.grid_for_reconstruction(
        torch.as_tensor(pts), params.particle_radius, params.compact_support_radius,
        params.cube_size)
    return pts, params, grid


def phase_splat_api(pt, dev, pts, grid, hsc, params, kernels, ident):
    """Phase 17 (run after phase 4, on its 2M dam break and grid): (a) the
    density splat API against the dense route's K1 level set, (b) padded
    marching cubes and the edge decoder, (c) the geoslot hysteresis, (d)
    the kernel gradient and the table kernel against float64. Returns the
    K1 and K2 launches of its main paths."""
    from splashsurf_tpu_torch import density as D
    from splashsurf_tpu_torch import kernels as K
    from splashsurf_tpu_torch import mc
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.mc.dense import _mc_counts, edge_layout
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    t_phase = time.perf_counter()
    h, mass, iso = params.compact_support_radius, params.particle_rest_mass, params.iso_surface_threshold
    log(f"phase 17: the splat API, padded marching cubes, the geoslot hysteresis and the "
        f"kernel helpers on the {pts.shape[0]}-particle dam break, grid {grid.n_cells} "
        f"({ident})")
    splat_tol = dict(rtol=2e-5, atol=1e-4)  # the reference's splat bar

    # (a) v = m / rho from the geoslot densities (K2), the K1 level set, the splat API
    N.reset_geoslot_hysteresis()
    reset_launches(sk)
    rho = N.compute_particle_densities(pts, h, mass)
    if N.LAST_GATE["kind"] != "geoslot":
        raise AssertionError(f"the dam break took {N.LAST_GATE['kind']}, not geoslot")
    values = mass / rho
    rasters, overflow = gs.rasterize_global(pts, values, grid, 2, hsc)
    ls = gs.sweep_global(rasters, overflow, grid, h, hsc)
    launches = {"sweep_global": sk.sweep_global_cuda.launches,
                "density_sweep": sk.density_sweep_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"phase 17 (a) launches {launches}")
    del rasters, overflow
    cap = 4096
    splat = lambda: D.splat_level_set(pts, values, grid, h, hsc, slots=4, overflow_capacity=cap)
    got, n_over = splat()
    n_over = int(n_over)
    if n_over > cap:
        raise AssertionError(f"{n_over} overflow particles past the capacity {cap}")
    err_s = compare("(a) splat_level_set (4 slots) vs K1", got, ls, splat_tol)
    del got
    scatter = lambda: D.splat_level_set_scatter(pts, values, grid, h, hsc)
    err_c = compare("(a) splat_level_set_scatter vs K1", scatter(), ls, splat_tol)
    ms_s, ms_c = cuda_ms(splat, 3), cuda_ms(scatter, 3)
    log(f"  (a) plain PyTorch, as the reference's are plain JAX: splat_level_set "
        f"{ms_s:.3f} ms ({n_over} overflow particles), splat_level_set_scatter {ms_c:.3f} ms; "
        f"max_abs_err {err_s:.3e} / {err_c:.3e} against K1 ({ident})")

    # splat_level_set_auto on a cloud with an overflow clump: it must retry
    small = pts[:100_000]
    clump = small[:1] + 1e-4 * torch.rand((2000, 3), device=dev, generator=torch.Generator(
        device=dev).manual_seed(17))
    cloud = torch.cat([small, clump])
    sgrid = pt.grid_for_reconstruction(cloud, RADIUS, h, params.cube_size)
    v = torch.full((cloud.shape[0],), 1e-3, device=dev)
    capacities = []
    splat_fn = D.splat_level_set

    def spy(*args, **kwargs):
        capacities.append(kwargs["overflow_capacity"])
        return splat_fn(*args, **kwargs)

    D.splat_level_set = spy
    try:
        auto = D.splat_level_set_auto(cloud, v, sgrid, h)
    finally:
        D.splat_level_set = splat_fn
    if len(capacities) < 2:
        raise AssertionError(f"splat_level_set_auto did not retry: capacities {capacities}")
    shsc = pt.kernel_extents(h, sgrid.cell_size).half_supported_cells
    compare("(a) splat_level_set_auto vs the scatter", auto,
            D.splat_level_set_scatter(cloud, v, sgrid, h, shsc), splat_tol)
    log(f"  (a) splat_level_set_auto on {cloud.shape[0]} particles (a 2000-particle clump): "
        f"{len(capacities) - 1} retries, overflow capacities {capacities}")
    del auto, cloud, clump

    # (b) padded marching cubes on the K1 level set, exact capacities
    nv, nt = _mc_counts(ls, iso)
    res = mc.marching_cubes_padded(ls, iso, grid.min, grid.cell_size, nv, nt)
    if (int(res.num_vertices), int(res.num_triangles)) != (nv, nt):
        raise AssertionError(f"padded counts {int(res.num_vertices)}, {int(res.num_triangles)} "
                             f"against {nv}, {nt}")
    ref = mc.marching_cubes(ls, iso, grid.cell_size, grid.min)
    if not (np.array_equal(res.vertices.cpu().numpy(), ref.vertices)
            and np.array_equal(res.triangles.cpu().numpy(), ref.triangles)):
        raise AssertionError("marching_cubes_padded differs from marching_cubes")
    _, gtris = gs.mc_global_cells(ls, grid, iso)
    if gtris.shape[0] != nt:
        raise AssertionError(f"{nt} triangles against the dense route's {gtris.shape[0]}")
    axis, ijk = mc.decode_edge_flat(res.vertex_edges, grid.n_points)
    _, strides, offsets, _ = edge_layout(grid.n_points)
    again = torch.as_tensor(offsets, device=dev)[axis] + sum(
        ijk[:, d] * torch.as_tensor([s[d] for s in strides], device=dev)[axis] for d in range(3))
    if not torch.equal(again, res.vertex_edges):
        raise AssertionError("decode_edge_flat does not invert edge_layout")
    log(f"  (b) marching_cubes_padded: {nv} vertices, {nt} triangles (the dense route's MC "
        f"{gtris.shape[0]}), equal to marching_cubes; decode_edge_flat round-trips "
        f"{nv} edge ids")
    del res, ref, gtris, ls

    # (c) the hysteresis: three colliding calls, then the dam break
    colliding = pts.clone()
    colliding[1] = colliding[0] + 1e-6  # two particles in one octant
    for k in range(N._GEOSLOT_MAX_CONSECUTIVE_MISSES):
        N.compute_particle_densities(colliding, h, mass)
        if not N.LAST_GATE["single"]["try_geoslot"] or N.LAST_GATE["kind"] != "raster":
            raise AssertionError(f"colliding call {k}: {N.LAST_GATE['single']}")
    del colliding
    reset_launches(sk)
    rho_off = N.compute_particle_densities(pts, h, mass)
    k2 = sk.density_sweep_cuda.launches
    if N.LAST_GATE["single"]["try_geoslot"] or N.LAST_GATE["kind"] != "raster" or k2 == 0:
        raise AssertionError(f"past the limit: {N.LAST_GATE['single']}, K2 launches {k2}")
    launches["density_sweep"] += k2
    N.reset_geoslot_hysteresis()
    rho_on = N.compute_particle_densities(pts, h, mass)
    if N.LAST_GATE["kind"] != "geoslot":
        raise AssertionError(f"after the reset the dam break took {N.LAST_GATE['kind']}")
    # the two formulations sum in different orders: at metre-scale
    # coordinates they differ by up to 2.7e-5 relative in f32, each within
    # 2e-5 of the f64 densities (ROADMAP.md, queue 3), so each is held there
    rho64 = N.compute_particle_densities(pts.double(), h, mass)
    if N.LAST_GATE["kind"] != "geoslot":
        raise AssertionError(f"the f64 dam break took {N.LAST_GATE['kind']}, not geoslot")
    err_off = compare("(c) raster densities past the limit vs f64", rho_off.double(), rho64, F32_TOL)
    err_on = compare("(c) geoslot densities after the reset vs f64", rho_on.double(), rho64, F32_TOL)
    rel = float(((rho_off - rho_on).abs() / rho_on).max())
    log(f"  (c) after {N._GEOSLOT_MAX_CONSECUTIVE_MISSES} colliding calls: try_geoslot False, "
        f"raster densities (K2 launched {k2} times); after the reset geoslot again; against "
        f"f64 max_abs_err {err_off:.3e} (raster) / {err_on:.3e} (geoslot), raster vs geoslot "
        f"{rel:.3e} relative")
    del rho_off, rho_on, rho64

    # (d) the kernel gradient and the table kernel against float64 on the host
    gen = torch.Generator(device=dev).manual_seed(5)
    dx = (torch.rand((1_000_000, 3), device=dev, generator=gen) - 0.5) * (1.2 * h)
    dx[:4] = 0.0
    grad = K.cubic_kernel_gradient(dx, h)
    want = K.cubic_kernel_gradient(dx.cpu().double(), h)
    scale = float(want.abs().max())
    torch.testing.assert_close(grad.cpu().double(), want, rtol=0, atol=1e-5 * scale)
    if not (grad[:4] == 0).all():
        raise AssertionError("the gradient at r = 0 is not 0")
    table = K.DiscreteSquaredDistanceCubicKernel(4096, h)
    r_sq = (dx * dx).sum(1)
    got = table.evaluate(r_sq)
    torch.testing.assert_close(got.cpu(), table.evaluate(r_sq.cpu()), rtol=0, atol=0)
    exact = K.cubic_kernel_rsq(r_sq.cpu().double(), h)
    err_t = float((got.cpu().double() - exact).abs().max())
    if err_t > 1e-2 * float(exact.max()):
        raise AssertionError(f"table kernel off by {err_t}")
    log(f"  (d) cubic_kernel_gradient on {dx.shape[0]} offsets within 1e-5 of the largest "
        f"float64 value ({scale:.4e}); the table kernel equal to its CPU evaluation, within "
        f"{err_t:.3e} of float64 W ({float(exact.max()):.4e} at 0)")
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def median_s(fn, reps=5):
    """Median host seconds of ``fn`` over ``reps`` calls after one warm-up,
    the card synchronised around each."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def phase_sharded(pt, dev, canyon, resident, slab_counts, pts_np, kernels, ident):
    """Phase 16: several shards in one process: four virtual shards on the
    card (or the real cards, where there are several): (a) the sharded
    densities on the 2M dam break against the single-device ones, (b) the
    sharded subdomain route on the 8M canyon against phase 7's resident
    mesh, (c) the route default parameters take with several devices, (d)
    the dry-run scene on 8 virtual shards against one device. Returns the
    K2 and K3 launches of its main paths."""
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import subdomains as S
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.parallel import mesh as pm
    from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded

    mesh_dev, resident_warm = resident
    n_cards = torch.cuda.device_count()
    devs = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0"] * 4
    D = len(devs)
    log(f"phase 16: {D} shards in one process, "
        + (f"one on each of {n_cards} cards" if n_cards > 1 else "virtual shards on one card")
        + f" ({ident})")
    launches = {"density_sweep": 0, "splat_sweep": 0}
    pm.set_devices(devs)
    S.STAGE_PEAKS = True
    try:
        # (a) K2 on each slab of the 2M dam break's geoslot lattice
        params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
        h, mass = params.compact_support_radius, params.particle_rest_mass
        pts = torch.as_tensor(pts_np, device=dev)
        N.reset_geoslot_hysteresis()
        single = N.compute_particle_densities(pts, h, mass)
        if N.LAST_GATE["kind"] != "geoslot":
            raise AssertionError(f"the dam break took {N.LAST_GATE['kind']}, not geoslot")
        mesh = pm.make_mesh()
        reset_launches(sk)
        rho = compute_particle_densities_sharded(pts, h, mass, mesh=mesh)
        k2 = sk.density_sweep_cuda.launches
        check_mask_launches(sk, 0)
        gate = N.LAST_GATE["sharded"]
        if gate["kind"] != "geoslot" or k2 != D:
            raise AssertionError(f"sharded densities took {gate['kind']} with {k2} K2 launches")
        if not torch.equal(rho, single):
            raise AssertionError(f"sharded densities differ from one device's by "
                                 f"{float((rho - single).abs().max())}")
        launches["density_sweep"] += k2
        t_sh = median_s(lambda: compute_particle_densities_sharded(pts, h, mass, mesh=mesh))
        t_1 = median_s(lambda: N.compute_particle_densities(pts, h, mass))
        log(f"  (a) sharded densities, {len(pts_np)}-particle dam break: geoslot lattice "
            f"{gate['dims']}, slabs of {gate['slab_w']} x-planes, rows per shard "
            f"{gate['rows']}; K2 launched {k2} times (once per shard); equal to one device's "
            f"bit for bit; median of 5: sharded {t_sh * 1e3:.3f} ms, one device "
            f"{t_1 * 1e3:.3f} ms ({ident})")
        del pts, single, rho

        # (b) the sharded subdomain route on the canyon, decomposition forced
        n = canyon.shape[0]
        reset_launches(sk)
        rec, secs, runs = subdomain_frames(pt, canyon, canyon_params(pt), 3)
        k3 = sk.splat_sweep_cuda.launches
        check_mask_launches(sk, k3)
        run = runs[-1]
        if not all(r["sharded"] and r["sharded_pairs"] and not r["streamed"] for r in runs):
            raise AssertionError("the canyon frames did not run sharded")
        if k3 != sum(r["splat_chunks"] for r in runs) or any(
                sh["B"] and not sh["splat_chunks"] for sh in run["shards"]):
            raise AssertionError(f"{k3} K3 launches for the shards' chunks")
        launches["splat_sweep"] += k3
        check_closed(pt, "sharded canyon", rec.mesh)
        atomics = any(r["atomics"] for r in runs)
        vdiff = check_streamed_mesh("the sharded 8M canyon", rec.mesh, mesh_dev, atomics)
        sharded_mesh = rec.mesh
        del rec
        log(f"  (b) reconstruct_surface, {n}-particle canyon, 64-cell subdomains: sharded "
            f"pairs {run['sharded_pairs']}, devices {run['devices']}; densities: sharded "
            f"wrapper {N.LAST_GATE['sharded']['kind']} ({N.LAST_GATE['sharded'].get('reason')}), "
            f"formulation {N.LAST_GATE['kind']}; B {run['B']}, pairs {run['n_pairs']}, raster "
            f"overflow {run['raster_overflow']}; shell table {run['shell_bytes']} bytes")
        for i, sh in enumerate(run["shards"]):
            log(f"    shard {i} ({sh['device']}): B {sh['B']}, pairs {sh['n_pairs']}, K3 "
                f"launches {sh['splat_chunks']} per frame; seconds "
                + ", ".join(f"{k} {v:.4f}" for k, v in sh["stage_s"].items()))
        log(f"  mesh {sharded_mesh.num_vertices} vertices, {sharded_mesh.num_triangles} "
            f"triangles, closed; equal to phase 7's resident mesh "
            f"({'within 1e-6' if atomics else 'bit for bit'}: triangle lists equal, max vertex "
            f"diff {vdiff:.3e})")
        for i, r in enumerate(runs):
            log(f"  frame {i} ({'cold' if i == 0 else 'warm'}) {secs[i]:.4f} s; stage seconds "
                "/ peak device memory: " + stage_line(r))
        warm = statistics.median(secs[1:])
        peak = max(max(r["peak_bytes"].values(), default=0) for r in runs)
        log(f"  frame seconds: cold {secs[0]:.4f}, warm {[round(x, 4) for x in secs[1:]]}; "
            f"warm median {warm:.4f} s = {n / warm / 1e6:.3f} Mparticles/s, "
            f"{warm / resident_warm:.3f}x phase 7's {resident_warm:.4f} s; K3 launches {k3} in "
            f"3 frames; peak device memory {peak} bytes ({peak / 1e9:.3f} GB) ({ident})")

        # (c) default parameters with several devices: no slabs, the sharded subdomains
        from splashsurf_tpu_torch.reconstruction import _bucket_grid, choose_route

        params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
        grid = _bucket_grid(pt.grid_for_reconstruction(
            canyon, RADIUS, params.compact_support_radius, params.cube_size))
        route = choose_route(params, grid, len(pm.devices("cuda")))
        reset_launches(sk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pt.reconstruct_surface(canyon, params)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        k3c = sk.splat_sweep_cuda.launches
        check_mask_launches(sk, k3c)
        launches["splat_sweep"] += k3c
        if route != "subdomain" or rec.subdomain_grid is None or not S.LAST_RUN["sharded"]:
            raise AssertionError(f"default parameters took {route}, sharded "
                                 f"{S.LAST_RUN.get('sharded')}")
        atomics_c = atomics or S.LAST_RUN["raster_overflow"] > 0
        vdiff_c = check_streamed_mesh("the default-parameter canyon", rec.mesh, sharded_mesh,
                                      atomics_c)
        dv = rec.mesh.num_vertices - slab_counts[0]
        dt = rec.mesh.num_triangles - slab_counts[1]
        rel = max(abs(dv) / slab_counts[0], abs(dt) / slab_counts[1])
        if rel > 1e-4:
            raise AssertionError(f"sharded and slab canyon counts differ by {rel:.3e} relative")
        log(f"  (c) default parameters on {D} devices: route {route}, sharded, "
            f"{S.LAST_RUN['n_subdomains']} subdomains, B {S.LAST_RUN['B']}; {t_c:.4f} s, K3 "
            f"launches {k3c}; mesh equal to (b)'s "
            f"({'within 1e-6' if atomics_c else 'bit for bit'}, max vertex diff "
            f"{vdiff_c:.3e}); against phase 13's slab mesh {slab_counts}: differences {dv} "
            f"vertices, {dt} triangles, {rel:.3e} relative")
        del rec, sharded_mesh

        # (d) the dry-run scene on 8 virtual shards against one device
        pts_d, params_d, grid_d = dryrun_scene(pt)
        pts_d = torch.as_tensor(pts_d, device=dev)
        pm.set_devices(None)
        one = S.reconstruct_surface_subdomain_grid(pts_d, params_d, grid_d, sharded=False)
        over1 = S.LAST_RUN["raster_overflow"]
        pm.set_devices(["cuda:0"] * 8)
        reset_launches(sk)
        eight = S.reconstruct_surface_subdomain_grid(pts_d, params_d, grid_d, sharded=True)
        k3d = sk.splat_sweep_cuda.launches
        check_mask_launches(sk, k3d)
        launches["splat_sweep"] += k3d
        run = S.LAST_RUN
        if not run["sharded"] or run["B"] < 64 or k3d != run["splat_chunks"]:
            raise AssertionError(f"dry-run scene: sharded {run['sharded']}, B {run['B']}, "
                                 f"{k3d} K3 launches")
        check_closed(pt, "dry-run scene", eight.mesh)
        atomics_d = over1 > 0 or run["raster_overflow"] > 0 or (
            N.LAST_GATE["kind"] == "binned8" and N.LAST_GATE["max_occ"] > 8)
        vdiff_d = check_streamed_mesh("the dry-run scene", eight.mesh, one.mesh, atomics_d)
        log(f"  (d) dry-run scene, {len(pts_d)} particles: 8 virtual shards (B per shard "
            f"{[sh['B'] for sh in run['shards']]}, K3 launches {k3d}) against one device: "
            f"{eight.mesh.num_vertices} vertices, {eight.mesh.num_triangles} triangles, "
            f"{'within 1e-6' if atomics_d else 'bit for bit'} (raster overflow "
            f"{run['raster_overflow']}, max vertex diff {vdiff_d:.3e})")
    finally:
        S.STAGE_PEAKS = False
        pm.set_devices(None)
    return launches


def csr_sets(offsets, indices):
    """The CSR lists with each row's indices sorted: per-particle sets."""
    offsets, indices = np.asarray(offsets), np.asarray(indices)
    rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    return offsets, indices[np.lexsort((indices, rows))]


def check_same_lists(name, a, b):
    """Two CSR lists (offsets, indices) hold the same per-particle sets;
    logs whether they also share the order within each list."""
    sa, sb = csr_sets(*a), csr_sets(*b)
    if not (np.array_equal(sa[0], sb[0]) and np.array_equal(sa[1], sb[1])):
        raise AssertionError(f"{name}: the neighbour sets differ")
    same = bool(np.array_equal(a[1], b[1]))
    log(f"  {name}: {len(a[0]) - 1} lists, {len(a[1])} entries, the same sets; the same "
        f"order too: {same}")


def phase_neighbors(pt, dev, cross, pts_np, ident):
    """Phase 14: the neighbour lists, CUDA input against CPU input."""
    from splashsurf_tpu_torch import neighbors as N

    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5, global_neighborhood_list=True)
    h = params.compact_support_radius
    log(f"phase 14: neighbour lists within h = {h}; reconstruct_surface with "
        f"global_neighborhood_list=True on {len(cross)} particles, CPU input vs CUDA input")
    rc = pt.reconstruct_surface(cross, params, device="cpu")
    rg = pt.reconstruct_surface(torch.as_tensor(cross, device=dev), params)
    for name, r in (("cpu", rc), ("cuda", rg)):
        if not isinstance(r.particle_neighbors, pt.NeighborhoodLists) or len(
            r.particle_neighbors) != len(cross):
            raise AssertionError(f"{name}: no neighbour list per particle")
    check_same_lists(f"{len(cross)}-particle dam break lists",
                     (rg.particle_neighbors.offsets, rg.particle_neighbors.indices),
                     (rc.particle_neighbors.offsets, rc.particle_neighbors.indices))
    del rc, rg

    pts = torch.as_tensor(pts_np, device=dev)
    N.neighbor_search_csr(pts, h)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    search_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, indices = N.neighbor_search_csr(pts, h)
        torch.cuda.synchronize()
        search_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    lists = N.lists_from_device_csr(counts, indices)
    build_s = time.perf_counter() - t0
    stats = pt.compute_neighborhood_stats(lists)
    log(f"  {len(pts_np)}-particle dam break on the card: search seconds "
        f"{[round(x, 4) for x in search_s]} (median {statistics.median(search_s):.4f}); host "
        f"lists (copy and NeighborhoodLists) {build_s:.3f} s; peak device memory {peak} bytes, "
        f"{peak - base} above the positions ({ident})")
    log(f"  compute_neighborhood_stats: max {stats.max_neighbors}, mean "
        f"{stats.avg_neighbors:.3f} over {stats.particles_with_neighbors} particles with "
        f"neighbours, {len(lists) - stats.particles_with_neighbors} without")
    t0 = time.perf_counter()
    cc, ci = N.neighbor_search_csr(pts.cpu(), h)
    cpu_s = time.perf_counter() - t0
    offs = lambda c: np.concatenate([[0], np.cumsum(c.cpu().numpy())])
    check_same_lists(f"{len(pts_np)}-particle dam break lists, CUDA vs CPU (CPU search "
                     f"{cpu_s:.1f} s)",
                     (offs(counts), indices.cpu().numpy()), (offs(cc), ci.numpy()))


def sync_calls(fn):
    """(fn(), the synchronising CUDA calls it made), counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: each such call (a read of
    the card, a copy from pageable host memory, a synchronise) warns once."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def upload_times(fn, reps=10):
    """Medians of ``reps`` calls of ``fn`` after two warm-up calls, in ms:
    (host until it returns, device between CUDA events around it, host
    until the card is done), each call starting on an idle card."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    host, device, done = [], [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        t1 = time.perf_counter()
        end.synchronize()
        t2 = time.perf_counter()
        host.append(1e3 * (t1 - t0))
        device.append(start.elapsed_time(end))
        done.append(1e3 * (t2 - t0))
    return tuple(statistics.median(v) for v in (host, device, done))


def phase_upload(dev, ident):
    """Phase 24: the upload of the benchmark's 13.2M numpy frame, pageable
    against staged (see the module's docstring)."""
    from splashsurf_tpu_torch import placement

    frame32 = benchmark_dam_frame(4, dev).cpu().numpy()
    frame64 = frame32.astype(np.float64)
    log(f"phase 24: the upload of a numpy frame, {frame32.shape[0]} particles "
        f"({frame32.nbytes} B as float32), {torch.get_num_threads()} host threads ({ident})")
    default = placement.UPLOAD_CHUNK_BYTES
    for name, frame in (("f32", frame32), ("f64 -> f32", frame64)):
        pageable = lambda: torch.as_tensor(frame, dtype=torch.float32, device=dev)
        staged = lambda: placement.as_device_tensor(frame, dev, torch.float32)
        want, n_page = sync_calls(pageable)
        got, n_staged = sync_calls(staged)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"upload {name}: the staged copy differs from the pageable one")
        if n_staged or not n_page:
            raise AssertionError(f"upload {name}: synchronising calls, staged {n_staged}, "
                                 f"pageable {n_page} (want 0 and at least 1)")
        gb = want.numel() * want.element_size() / 1e9
        runs = [("pageable", pageable, None)]
        runs += [(f"staged {mb} MiB", staged, mb << 20) for mb in (4, 16, 64)]
        for label, fn, chunk in runs:
            placement.UPLOAD_CHUNK_BYTES = chunk or default
            try:
                host, device, done = upload_times(fn)
            finally:
                placement.UPLOAD_CHUNK_BYTES = default
            log(f"  {name} {label}: host {host:.3f} ms, device {device:.3f} ms, done "
                f"{done:.3f} ms = {gb / done * 1e3:.2f} GB/s of float32 ({ident})")
        log(f"  {name}: equal bit for bit; synchronising calls pageable {n_page}, staged "
            f"{n_staged}; default chunk {default >> 20} MiB")


def kernel_trace(fn):
    """(wall seconds, the card's kernels) of one call of ``fn`` that ends
    in a synchronise, under ``torch.profiler`` (CUDA activity only): the
    kernels as the trace's events, each with its ``name`` and ``dur`` (us);
    the kernels of a replayed CUDA graph are among them."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return wall, [e for e in events if e.get("cat") == "kernel"]


def idle_share(fn, top=None):
    """(wall seconds, idle share) of one call of ``fn`` that ends in a
    synchronise: the idle share is 1 - the summed time of the card's kernels
    in a ``torch.profiler`` trace (``kernel_trace``) over the wall time;
    None when the trace holds no kernel. The profiler's own host cost is in
    the wall time, so the share is an upper bound. With ``top``, also logs
    the ``top`` kernels by summed time (name, launches, ms)."""
    wall, kernels = kernel_trace(fn)
    busy_us = sum(e.get("dur", 0) for e in kernels)
    if top:
        by_name = {}
        for e in kernels:
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + e.get("dur", 0))
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        log(f"  {len(kernels)} kernels, {busy_us * 1e-3:.3f} ms in all; the top {top}: "
            + "; ".join(f"{name[:60]} x{n} {us * 1e-3:.3f} ms" for name, (n, us) in rows))
    return wall, (None if busy_us == 0 else 1.0 - busy_us * 1e-6 / wall)


def clear_plans():
    """Forget every speculative plan of the port: the next frame is cold."""
    from splashsurf_tpu_torch import neighbors, plans, reconstruction

    neighbors.clear_density_plan()
    reconstruction.clear_grid_plan()
    for plan in (plans.OVER_PLAN, plans.MC_CAPS, plans.PULL_PLAN, plans.PULL_PLAN_ENC):
        plan.clear()


def stats_delta(before):
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    return {k: v - before[k] for k, v in SPECULATION_STATS.items() if v != before[k]}


def phase_plans(pt, pts, params, ident):
    """Phase 18: frames of phase 4's scene, ``pts + k 1e-6`` as CUDA tensors,
    on the frame plans.

    (a) The chain a user runs: a cold frame 0, then warm frames 1-5, each on
    the plans of the frame before it. Each warm frame is dispatched under
    ``torch.cuda.set_sync_debug_mode("error")`` up to its ``resolve()`` (a
    read of the card fails the phase), launches K1 and K2 once and moves
    ``SPECULATION_STATS`` by one frame and no miss. Its mesh is held to the
    same frame run with the plans cleared by nearest neighbour, both ways,
    within 1e-4: between these frames the geoslot lattice may re-phase (its
    origin is quantized to s / 4096 = 5.4e-6 m), and float32 densities on
    another origin differ by the fractions' rounding, up to ~1e-5 relative.
    (b) Each frame on its own plans: the plans cleared, frame k run cold,
    then frame k again, warm, under the same checks: equal counts and
    vertices within 1e-6 of the cold run. (c) The seconds of (a)'s warm
    frames and of the plan-cleared ones, the synchronising calls of a frame
    of each, and the card's idle share over a frame of each. (d) A frame
    shifted by two cells misses its grid plan and gives the cold frame's
    mesh."""
    from scipy.spatial import cKDTree

    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import plans
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    log(f"phase 18: {N_FRAMES} frames of pts + k 1e-6 on the frame plans")

    def warm_frame(f, label):
        before = dict(SPECULATION_STATS)
        reset_launches(sk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rec = pt.reconstruct_surface(f, params, _defer_pull=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rec.resolve()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (sk.sweep_global_cuda.launches, sk.density_sweep_cuda.launches,
                    sk.binned_sweep_cuda.launches)
        if launches != (1, 1, 0):
            raise AssertionError(f"{label}: (K1, K2, K5) launches {launches}, want (1, 1, 0)")
        if stats_delta(before) != {"frames": 1}:
            raise AssertionError(f"{label}: SPECULATION_STATS moved {stats_delta(before)}")
        return rec, dt

    def cold_frame(f):
        clear_plans()
        return pt.reconstruct_surface(f, params)

    def lattice():
        (plan,) = plans.DENSITY_PLAN.values()
        return plan["grid"].min

    N.reset_geoslot_hysteresis()
    frames = [pts + k * 1e-6 for k in range(N_FRAMES)]
    cold_frame(frames[0])
    chain_lattice = lattice()
    chain, warm_s, cold_s = [], [], []
    for k, f in enumerate(frames[1:], 1):
        rec, dt = warm_frame(f, f"warm frame {k}")
        chain.append(rec)
        warm_s.append(dt)
    for k, f in enumerate(frames[1:], 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = cold_frame(f)
        torch.cuda.synchronize()
        cold_s.append(time.perf_counter() - t0)
        moved = lattice() != chain_lattice
        check_same_mesh(f"warm frame {k} / plans cleared (lattice re-phased: {moved})",
                        chain[k - 1].mesh, cold.mesh, ordered=False, tree=cKDTree,
                        same_counts=False)
        rec, _ = warm_frame(f, f"frame {k} on its own plans")
        check_same_mesh(f"frame {k} on its own plans / plans cleared", rec.mesh, cold.mesh,
                        ordered=True, tol=1e-6)
    warm_sync = sync_calls(lambda: pt.reconstruct_surface(frames[1], params))[1]
    warm_wall, warm_idle = idle_share(lambda: pt.reconstruct_surface(frames[2], params), top=8)
    cold_sync = sync_calls(lambda: cold_frame(frames[3]))[1]
    cold_wall, cold_idle = idle_share(lambda: cold_frame(frames[4]), top=8)
    # a frame shifted past a grid cell: the grid plan misses, the frame runs cold
    shifted = pts + 2.0 * params.cube_size
    before = dict(SPECULATION_STATS)
    rec = pt.reconstruct_surface(shifted, params)
    moved = stats_delta(before)
    if moved.get("grid_miss") != 1:
        raise AssertionError(f"the shifted frame did not miss its grid plan: {moved}")
    check_same_mesh("shifted frame / plans cleared", rec.mesh, cold_frame(shifted).mesh,
                    ordered=True, tol=1e-6)
    log(f"  warm frames on the plans: seconds {warm_s}, median {statistics.median(warm_s)}; "
        f"K1 and K2 launched once each, no synchronising call up to resolve()")
    log(f"  plans cleared before each frame: seconds {cold_s}, median "
        f"{statistics.median(cold_s)}")
    log(f"  synchronising calls in one frame: on the plans {warm_sync}, plans cleared "
        f"{cold_sync}; idle share under the profiler: on the plans {warm_idle} over "
        f"{warm_wall} s, plans cleared {cold_idle} over {cold_wall} s ({ident})")
    log(f"  the shifted frame: SPECULATION_STATS moved {moved}; the cold frame's mesh")


class switches:
    """The environment switches ``env`` (name -> value, None unsets) for the
    body of a ``with`` block, restored after."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase 19's pull modes of the dense route: label -> switches
PULL_MODES = {
    "packed": dict(SPLASHSURF_TPU_PULL="packed", SPLASHSURF_TPU_MC=None),
    "encoded, u16 t": dict(SPLASHSURF_TPU_PULL="encoded", SPLASHSURF_TPU_PULL_QUANT="1",
                           SPLASHSURF_TPU_MC=None),
    "encoded, f32 t": dict(SPLASHSURF_TPU_PULL="encoded", SPLASHSURF_TPU_PULL_QUANT="0",
                           SPLASHSURF_TPU_MC=None),
    "edges": dict(SPLASHSURF_TPU_PULL="packed", SPLASHSURF_TPU_MC="edges"),
}


def closed_on_card(name, mesh, dev):
    """Every directed edge of the mesh's triangles once and its reverse
    once: each undirected edge in exactly two triangles, with opposite
    orientations (a closed, consistently oriented surface). On the card:
    ``check_mesh_consistency`` takes tens of host seconds on 18.6M
    triangles."""
    t = torch.as_tensor(mesh.triangles, device=dev).long()
    a = t.reshape(-1)
    b = t[:, [1, 2, 0]].reshape(-1)
    n = int(mesh.num_vertices)
    fwd = torch.sort(a * n + b).values
    rev = torch.sort(b * n + a).values
    once = bool((fwd[1:] != fwd[:-1]).all())
    if not (once and torch.equal(fwd, rev)) or not np.isfinite(mesh.vertices).all():
        raise AssertionError(f"{name}: the mesh is not closed and consistently oriented")


def pull_tol(mesh, cs, quant):
    """How far a decoded vertex may lie from the card's: cell_size / 65535 *
    1.01 with u16 t (the reference's bar), plus 4 float32 ulps of the
    largest coordinate (the host rounds mn + ijk cs and then + t cs apart,
    where the card may fuse them; at the canyon's 44 m an ulp is 3.8e-6)."""
    ulp = float(np.spacing(np.float32(np.abs(mesh.vertices).max())))
    return (cs / 65535 * 1.01 if quant else 0.0) + 4 * ulp


def phase_encoded(pt, dev, canyon, pts_np, ident):
    """Phase 19: the encoded mesh pull and edge-major marching cubes.

    (a) The 2M dam break on the dense route in each of ``PULL_MODES``: the
    plans cleared, one cold frame and five warm ones (``pts + k 1e-6``),
    each warm frame dispatched under ``set_sync_debug_mode("error")`` up to
    its ``resolve()`` with K1 and K2 launched once; the bytes of its mesh
    copy, the host decode seconds, the device seconds of marching cubes in
    the mode (CUDA events on the cold frame's level set) and the frame
    seconds. Every mode's last mesh has the packed mesh's triangle list and
    its vertices within ``pull_tol``; every f32 decode ran in the native
    decoder. (b) The 8M canyon on default parameters (the slab route, 8
    slabs), a packed and an encoded frame: stage seconds, bytes, the same
    triangle list and the vertices within ``pull_tol``. (c) The 8M canyon
    on the subdomain route (decomposition forced), resident: the stitch
    against the encoded pull with the stage split
    (``enable_profile_sync(True)``), then a frame of each without the
    synchronisation: equal counts, a sample of the encoded vertices within
    ``pull_tol`` of the stitched ones, the encoded mesh closed and
    consistently oriented (``closed_on_card``); one
    streamed encoded frame and one on four virtual shards, both the
    resident encoded mesh bit for bit (within 1e-6 where a sum ran with
    atomics)."""
    from scipy.spatial import cKDTree

    from splashsurf_tpu_torch import native
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch import plans
    from splashsurf_tpu_torch import subdomains as S
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import slab_sweep as slab
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    params = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    h = params.compact_support_radius
    pts = torch.as_tensor(pts_np, device=dev)
    frames = [pts + k * 1e-6 for k in range(6)]
    log(f"phase 19: the mesh pulls, {len(pts_np)}-particle dam break ({ident})")
    native.DECODE_STATS.update(native=0, numpy=0)
    meshes, rows = {}, []
    for label, env in PULL_MODES.items():
        with switches(**env):
            clear_plans()
            N.reset_geoslot_hysteresis()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = pt.reconstruct_surface(frames[0], params)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            cold_bytes = gs.LAST_PULL["bytes"]
            warm_s, decode_s, nbytes_ = [], [], []
            for k, f in enumerate(frames[1:], 1):
                before = dict(SPECULATION_STATS)
                reset_launches(sk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    rec = pt.reconstruct_surface(f, params, _defer_pull=True)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                rec.resolve()
                torch.cuda.synchronize()
                warm_s.append(time.perf_counter() - t0)
                launches = (sk.sweep_global_cuda.launches, sk.density_sweep_cuda.launches)
                if launches != (1, 1):
                    raise AssertionError(f"{label} warm frame {k}: (K1, K2) launches {launches}")
                if stats_delta(before) != {"frames": 1}:
                    raise AssertionError(f"{label} warm frame {k}: {stats_delta(before)}")
                decode_s.append(gs.LAST_PULL["decode_s"])
                nbytes_.append(gs.LAST_PULL["bytes"])
                if gs.LAST_PULL["mode"] != ("edges" if "edges" in label else label.split(",")[0]):
                    raise AssertionError(f"{label}: the pull ran as {gs.LAST_PULL['mode']}")
            # device seconds of marching cubes in this mode, on frame 0's level set
            grid = cold.grid
            hsc = pt.kernel_extents(h, grid.cell_size).half_supported_cells
            rho = N.compute_particle_densities(frames[0], h, params.particle_rest_mass)
            r, o = gs.rasterize_global(frames[0], params.particle_rest_mass / rho, grid, 2, hsc)
            ls = gs.sweep_global(r, o, grid, h, hsc)
            del r, o, rho
            caps = plans.MC_CAPS[(grid.n_points, str(ls.dtype))]
            iso = params.iso_surface_threshold
            mc_ms = cuda_ms(lambda: gs._dense_mc(ls, grid, iso, caps), 5)
            del ls
        meshes[label] = rec.mesh
        rows.append((label, cold_s, warm_s, cold_bytes, nbytes_, decode_s, mc_ms))
        log(f"  {label}: cold frame {cold_s:.4f} s, warm {[round(x, 5) for x in warm_s]}, "
            f"median {statistics.median(warm_s):.5f} s; bytes copied cold {cold_bytes}, warm "
            f"{nbytes_[-1]}; host decode {[round(x, 5) for x in decode_s]} s; device MC "
            f"{mc_ms:.3f} ms; no synchronising call up to resolve(), K1 and K2 once")
    if native.DECODE_STATS["numpy"] or not native.DECODE_STATS["native"]:
        raise AssertionError(f"the f32 decodes did not all run natively: {native.DECODE_STATS}")
    base = meshes["packed"]
    cs = float(params.cube_size)
    for label, mesh in meshes.items():
        tol = pull_tol(base, cs, "u16" in label)
        check_same_mesh(f"{label} / packed", mesh, base, ordered=True, tol=tol)
        if not (mesh.triangles == base.triangles).all():
            raise AssertionError(f"{label}: the triangle list differs from the packed one")
    log(f"  native decodes {native.DECODE_STATS}")
    del frames, pts

    # (b) the slab route on default parameters
    sparams = pt.Parameters.new_relative(RADIUS, 4.0, 1.5)
    slab_mesh = {}
    for label in ("packed", "encoded, u16 t"):
        with switches(**PULL_MODES[label]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = pt.reconstruct_surface(canyon, sparams)
            torch.cuda.synchronize()
            secs = [time.perf_counter() - t0]
        run = slab.LAST_RUN
        if not run.get("slabbed"):
            raise AssertionError("the canyon on default parameters did not take the slab route")
        mesh = rec.mesh
        nbytes_ = run.get("pull_bytes", mesh.vertices.nbytes + mesh.triangles.nbytes)
        slab_mesh[label] = mesh
        log(f"  slab route, {label}: {run['n_slabs']} slabs; frame {secs[0]:.4f} s (warm: "
            f"phase 13 built the kernels); bytes copied {nbytes_}; stages "
            + ", ".join(f"{k} {v:.4f}" for k, v in run["stage_s"].items()))
    check_same_mesh("slab route encoded / packed", slab_mesh["encoded, u16 t"],
                    slab_mesh["packed"], ordered=True,
                    tol=pull_tol(slab_mesh["packed"], cs, True))
    if not (slab_mesh["encoded, u16 t"].triangles == slab_mesh["packed"].triangles).all():
        raise AssertionError("slab route: the encoded triangle list differs from the packed one")
    del slab_mesh  # the packed mesh's triangles, which phase 13 found closed

    # (c) the subdomain route, decomposition forced
    cparams = canyon_params(pt)
    sub = {}
    for label, enc in (("stitch", "0"), ("encoded", "1")):
        with switches(SPLASHSURF_TPU_SUB_ENCODED_PULL=enc, SPLASHSURF_TPU_STREAM="0"):
            S.enable_profile_sync(True)
            rec, secs, runs = subdomain_frames(pt, canyon, cparams, 1)
            S.enable_profile_sync(False)
            _, free, _ = subdomain_frames(pt, canyon, cparams, 1)
        sub[label] = (rec.mesh, runs[-1])
        mesh = rec.mesh
        nbytes_ = runs[-1].get("pull_bytes", mesh.vertices.nbytes + mesh.triangles.nbytes)
        log(f"  subdomain route, {label}: frames synchronised {[round(x, 4) for x in secs]} s, "
            f"not synchronised {free[0]:.4f} s; bytes copied {nbytes_}; stages (synchronised) "
            + ", ".join(f"{k} {v:.4f}" for k, v in runs[-1]["stage_s"].items()))
    S.enable_profile_sync(True)
    enc_mesh, enc_run = sub["encoded"]
    closed_on_card("subdomain encoded", enc_mesh, dev)
    stitched = sub.pop("stitch")[0]
    if (enc_mesh.num_vertices, enc_mesh.num_triangles) != (
            stitched.num_vertices, stitched.num_triangles):
        raise AssertionError("subdomain route: the encoded and stitched counts differ")
    # the vertex sets: a seeded sample of 500,000 encoded vertices, each
    # within pull_tol of a stitched one (the whole sets both ways take a
    # minute of host time; the CPU tests compare them whole)
    sample = np.random.default_rng(0).choice(enc_mesh.num_vertices, 500_000, replace=False)
    d = float(cKDTree(stitched.vertices).query(enc_mesh.vertices[sample], workers=-1)[0].max())
    if d > pull_tol(enc_mesh, cs, True):
        raise AssertionError(f"subdomain encoded / stitch: a vertex {d} from the stitched set")
    log(f"  subdomain encoded / stitch: {enc_mesh.num_vertices} vertices, "
        f"{enc_mesh.num_triangles} triangles in both; sampled vertices within {d:.3e}")
    del stitched
    with switches(SPLASHSURF_TPU_SUB_ENCODED_PULL="1", SPLASHSURF_TPU_STREAM="1"):
        rec, secs, runs = subdomain_frames(pt, canyon, cparams, 1)
    if not runs[0]["streamed"]:
        raise AssertionError("the streamed frame did not stream")
    d = check_streamed_mesh("streamed encoded", rec.mesh, enc_mesh,
                            runs[0]["atomics"] or enc_run["atomics"])
    log(f"  streamed encoded: {secs[0]:.4f} s, {runs[0]['splat_chunks']} chunks, max vertex "
        f"diff to resident {d}; stages " + ", ".join(
            f"{k} {v:.4f}" for k, v in runs[0]["stage_s"].items()))
    pmesh.set_devices([dev] * 4)
    try:
        with switches(SPLASHSURF_TPU_SUB_ENCODED_PULL="1", SPLASHSURF_TPU_STREAM="0"):
            rec, secs, runs = subdomain_frames(pt, canyon, cparams, 1)
    finally:
        pmesh.set_devices(None)
    if not runs[0]["sharded"] or len(runs[0]["devices"]) != 4:
        raise AssertionError(f"the sharded frame ran on {runs[0]['devices']}")
    d = check_streamed_mesh("four shards encoded", rec.mesh, enc_mesh,
                            runs[0]["atomics"] or enc_run["atomics"])
    log(f"  four virtual shards, encoded: {secs[0]:.4f} s, max vertex diff to resident {d}; "
        "stages " + ", ".join(f"{k} {v:.4f}" for k, v in runs[0]["stage_s"].items()))
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")


def with_room(pts):
    """The scene with its last 8 particles moved into a 2 x 2 x 2 droplet
    beyond its top corner: room in the bounding box for ``spikes``."""
    s = 2 * RADIUS
    f = pts.clone()
    lo, hi = f[:-8].amin(0), f[:-8].amax(0)
    cube = torch.stack(torch.meshgrid(*[torch.arange(2, device=f.device)] * 3, indexing="ij"),
                       -1).reshape(-1, 3).to(f.dtype) * s
    corner = torch.stack([hi[0] + 3.5 * s, hi[1] + 3.5 * s, (lo[2] + hi[2]) / 2])
    f[-8:] = corner + cube
    return f


def spikes(f):
    """Every other particle of the block's top and +x faces (a
    checkerboard) moved out by 3 spacings: isolated blobs, each with a
    surface of its own, inside the bounding box of ``with_room``."""
    s = 2 * RADIUS
    f = f.clone()
    for axis, (a, b) in ((1, (0, 2)), (0, (1, 2))):
        c = f[:-8, axis]
        face = torch.nonzero(c > c.max() - 0.5 * s)[:, 0]
        parity = (torch.round(f[face, a] / s) + torch.round(f[face, b] / s)).long() % 2
        f[face[parity == 0], axis] += 3 * s
    return f


# the axes along which each frame of phase 20 (f) moves its grid origin
ORIGIN_MOVES = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 1, 1)]


def moved_origin_frames(pt, pts_np, params, moves=ORIGIN_MOVES, eps=1e-4):
    """Numpy frames whose grids differ in their origin alone: ``pts_np``
    translated so that the minimum of its grown AABB lies ``eps`` above a
    cell boundary on each axis (the plan frame), then that frame moved by
    -2 ``eps`` along the axes of each of ``moves``, which puts the grid's
    origin one cell lower there. No particle moves by more than 2 ``eps``,
    so the plans of the plan frame hold. (A move by a whole cell keeps the
    grid's phase but moves every particle by 3/4 of a geoslot octant, so
    the density plan's octant check fails; a move by a whole particle
    spacing keeps the octants but changes the grid's phase, and the mesh's
    counts with it, past the pull plan's buckets.) Returns the plan frame
    and the moved frames, each grid checked on the host: one size, and an
    origin of its own."""
    from splashsurf_tpu_torch.reconstruction import _bucket_grid
    from splashsurf_tpu_torch.uniform_grid import kernel_extents

    r, h, cs = params.particle_radius, params.compact_support_radius, params.cube_size
    low = pts_np.min(0).astype(np.float64) - r - kernel_extents(h, cs).kernel_evaluation_radius
    base = (pts_np + (np.ceil(low / cs) * cs - low + eps)).astype(np.float32)
    frames = [(base - np.float32(2 * eps) * np.float32(m)).astype(np.float32) for m in moves]
    grids = [_bucket_grid(pt.grid_for_reconstruction(torch.as_tensor(f), r, h, cs))
             for f in [base] + frames]
    if len({g.n_points for g in grids}) != 1 or len({g.min for g in grids}) != len(grids):
        raise AssertionError(f"moved origins: grids {[(g.min, g.n_points) for g in grids]}")
    return base, frames


def plan_state():
    """A copy of every plan of the port (to run a frame twice on them)."""
    from splashsurf_tpu_torch import neighbors, plans

    return [(d, type(d)(d)) for d in (
        plans.DENSITY_PLAN, plans.GRID_PLAN, plans.GRID_NOSPEC, plans.GRID_MOVED,
        plans.PENDING_NOSPEC, plans.OVER_PLAN, plans.MC_CAPS, plans.PULL_PLAN,
        plans.PULL_PLAN_ENC)] + [(neighbors._GEOSLOT_MISSES, list(neighbors._GEOSLOT_MISSES))]


def restore_plans(state):
    for live, saved in state:
        live.clear()
        (live.extend if isinstance(live, list) else live.update)(saved)


# the kernels of the mono frame's path and their pre-passes as a trace names
# them (K3's tile kernel has K1's name; K3 is not on this path)
TRACED = {"sweep_global": "level_set_tiles", "occupancy_masks": "occupancy_mask_kernel",
          "density_sweep": "density_sweep_kernel", "bin_occupancy": "bin_occupancy_kernel"}


# what the mono frame's graph holds of the kernels (``frame_graph.kernels``):
# K1 and K2 and their pre-passes, and K6, once each
GRAPH_KERNELS = {"occupancy_masks_cuda": 1, "sweep_global_cuda": 1, "bin_occupancy_cuda": 1,
                 "density_sweep_cuda": 1, "slot_raster_cuda": 1}


def traced_launches(kernels):
    """The launches of each kernel of ``TRACED`` among a trace's kernels."""
    return {k: sum(name in e["name"] for e in kernels) for k, name in TRACED.items()}


@contextlib.contextmanager
def replay_spans(FG):
    """Within it, each replay of a warm frame's graph (its input copy
    included) lies between two CUDA events on its stream; yields the list
    of (start, end) event pairs, one per replay."""
    spans = []
    replay = FG._FrameGraph.replay

    def timed(self, positions):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = replay(self, positions)
        end.record()
        spans.append((start, end))
        return out

    FG._FrameGraph.replay = timed
    try:
        yield spans
    finally:
        FG._FrameGraph.replay = replay


def phase_mono(pt, pts, params, ident):
    """Phase 20: the single-dispatch warm frame (``SPLASHSURF_TPU_MONO_FRAME=1``)
    as one CUDA graph per plan set, on phase 18's frames ``pts + k 1e-6``.

    (a) With ``SPLASHSURF_TPU_PREWARM=1``, the cold frame 0, whose
    discarded warm frame captures the graph; then warm frames 1-5, each one
    replay of that graph: no kernel launched eagerly (the wrappers' counts
    stay 0), ``SPECULATION_STATS`` moved by one frame, no capture, the
    synchronising calls printed (the one read of the pull at most), and the
    graph holding K1 and K2 and their pre-passes once each (the launches
    its capture queued, ``frame_graph.kernels``); the same frame again on
    the same plans under ``torch.profiler``, whose records of those kernels
    are logged, not held: a trace may lack a replayed kernel's record. (b)
    Each warm frame's mesh and densities against the per-stage warm frame
    (``MONO_FRAME=0``) of the same input on the same plans: equal triangle
    lists and vertices, bit for bit. (c) The seconds of the replayed frames
    against the per-stage ones of (b), taken in turns, and the device
    milliseconds of each replay between CUDA events (``replay_spans``),
    with no profiler; kernels, seconds and idle share of one frame of each
    under ``torch.profiler``; the graph pool's bytes, the peak device
    memory of a frame of each, the capture's seconds, and a planning
    frame's seconds with ``PREWARM`` "1" and "0".
    (d) On the scene with room for spikes (``with_room``): a caps miss
    (``spikes``), a density miss (a particle on another's position) and a
    grid miss (a shift of two cells), each the per-stage frame's mesh on
    the plans it found (bit for bit), then the same frame again: warm, on a
    graph captured after the miss. (e) With ``SPLASHSURF_TPU_PULL=encoded``: the replayed frames'
    mesh within ``pull_tol`` of (a)'s packed one. (f) Numpy frames, whose
    grid is derived anew each frame: after a planning frame, six frames on
    grid origins one cell apart (``moved_origin_frames``), each a mono
    frame that captures; after each, one live graph, its pool within 1.1 x
    (c)'s; the reserved memory after the sixth less that after the second
    below one pool; the sixth frame's mesh and densities the per-stage
    frame's bit for bit; then that frame three times more, replayed. The
    switches and the plans are restored after. Returns the K1 and K2
    launches that the replays of (a) ran."""
    from splashsurf_tpu_torch import frame_graph as FG
    from splashsurf_tpu_torch import global_pipeline as gp
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    log(f"phase 20: the mono frame, one CUDA graph per plan set ({ident})")
    t_phase = time.perf_counter()
    frames = [pts + k * 1e-6 for k in range(N_FRAMES)]
    outcomes = []
    try_warm = gp._try_warm_frame

    def spy(*args, **kwargs):
        try:
            out = try_warm(*args, **kwargs)
        except Exception as e:
            outcomes.append(type(e).__name__)
            raise
        outcomes.append(out is not None or gp.LAST_WARM["outcome"])
        return out

    def frame(f, mono):
        """(the frame's result, its seconds, its synchronising calls up to
        the synchronise that ends it)"""
        with switches(SPLASHSURF_TPU_MONO_FRAME=mono):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec, n_sync = sync_calls(lambda: pt.reconstruct_surface(f, params))
            torch.cuda.synchronize()
            return rec, time.perf_counter() - t0, n_sync

    def same(label, a, b):
        if not (np.array_equal(a.mesh.triangles, b.mesh.triangles)
                and np.array_equal(a.mesh.vertices, b.mesh.vertices)):
            d = (float(np.abs(a.mesh.vertices - b.mesh.vertices).max())
                 if a.mesh.vertices.shape == b.mesh.vertices.shape else None)
            raise AssertionError(f"{label}: the mono mesh is not the per-stage one (max {d})")
        if not torch.equal(a.particle_densities, b.particle_densities):
            raise AssertionError(f"{label}: the densities differ from the per-stage ones")

    launches = {"sweep_global": 0, "density_sweep": 0}
    gp._try_warm_frame = spy
    try:
        with switches(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PULL="packed",
                      SPLASHSURF_TPU_MC=None, SPLASHSURF_TPU_DENSITY_CELLRASTER=None):
            # (c) planning frames without and with their discarded frame, in
            # turns; the last one's plans and graph serve the warm frames
            plan_s = {"0": [], "1": []}
            for pre in ("0", "1", "0", "1"):
                clear_plans()
                N.reset_geoslot_hysteresis()
                captures = FG.STATS["captures"]
                with switches(SPLASHSURF_TPU_PREWARM=pre):
                    plan_s[pre].append(frame(frames[0], "1")[1])
                if FG.STATS["captures"] - captures != int(pre):
                    raise AssertionError(f"PREWARM={pre}: {FG.STATS['captures'] - captures} "
                                         "captures in the planning frame")
            capture_s, pool = FG.STATS["capture_s"], FG.pool_bytes()
            # (a), (b), (c): warm frames, mono then per-stage on the same plans
            mono_s, stage_s, syncs, span_ms, traced = [], [], [], [], []
            for k, f in enumerate(frames[1:], 1):
                before, replays = dict(SPECULATION_STATS), FG.STATS["replays"]
                captures = FG.STATS["captures"]
                reset_launches(sk)
                outcomes.clear()
                state = plan_state()
                with replay_spans(FG) as spans:
                    mono, dt, n_sync = frame(f, "1")
                eager = {fn.__name__: fn.launches for fn in sk.WRAPPERS if fn.launches}
                if eager or outcomes != [True] or len(spans) != 1:
                    raise AssertionError(f"warm frame {k}: eager launches {eager}, outcomes "
                                         f"{outcomes}, {len(spans)} replays")
                span_ms.append(spans[0][0].elapsed_time(spans[0][1]))
                if stats_delta(before) != {"frames": 1}:
                    raise AssertionError(f"warm frame {k}: {stats_delta(before)}")
                moved = (FG.STATS["replays"] - replays, FG.STATS["captures"] - captures)
                if moved != (1, 0):
                    raise AssertionError(f"warm frame {k}: (replays, captures) {moved}, want "
                                         "(1, 0)")
                if n_sync > 1:
                    raise AssertionError(f"warm frame {k}: {n_sync} synchronising calls")
                mono_s.append(dt)
                # what the replay ran: the launches its graph's capture queued
                graph = FG.kernels(f.device)
                if graph != GRAPH_KERNELS:
                    raise AssertionError(f"warm frame {k}: the replayed graph holds {graph}, "
                                         f"want {GRAPH_KERNELS}")
                for name in launches:
                    launches[name] += graph[name + "_cuda"]
                # the same frame on the same plans under the profiler: the
                # records its trace holds of the replay's kernels (logged)
                restore_plans(state)
                outcomes.clear()
                traced.append(traced_launches(kernel_trace(lambda: frame(f, "1"))[1]))
                if outcomes != [True]:
                    raise AssertionError(f"warm frame {k} traced: outcomes {outcomes}")
                restore_plans(state)
                stage, dt, stage_sync = frame(f, "0")
                stage_s.append(dt)
                syncs.append((n_sync, stage_sync))
                same(f"warm frame {k}", mono, stage)
            busy = [ms * 1e-3 / s for ms, s in zip(span_ms, mono_s)]
            log(f"  warm frames replayed: seconds {mono_s}, median {statistics.median(mono_s)}; "
                f"per-stage on the same plans: {stage_s}, median {statistics.median(stage_s)}; "
                f"no eager launch; one replay each of a graph whose capture queued K1, K2, "
                f"their pre-passes and K6 once each ({GRAPH_KERNELS}); synchronising calls "
                f"(replayed, per-stage) {syncs}; meshes and densities equal to the per-stage "
                f"frames bit for bit")
            short = sum(t != dict.fromkeys(TRACED, 1) for t in traced)
            log(f"  the profiler's records of those kernels in a trace of each replay: {traced}; "
                f"{short} of {len(traced)} traces lack a record")
            log(f"  the replays' device span (CUDA events, no profiler): ms {span_ms}, median "
                f"{statistics.median(span_ms)}; share of the frame's wall time {busy}, median "
                f"{statistics.median(busy)} ({ident})")
            mono_wall, mono_idle = idle_share(lambda: frame(frames[2], "1"), top=8)
            stage_wall, stage_idle = idle_share(lambda: frame(frames[2], "0"), top=8)
            last_packed, peaks = mono, {}
            for switch in ("1", "0"):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                frame(frames[3], switch)
                peaks[switch] = torch.cuda.max_memory_allocated() - base
            log(f"  one frame under the profiler: replayed {mono_wall} s, idle {mono_idle}; "
                f"per-stage {stage_wall} s, idle {stage_idle}")
            log(f"  graph pool {pool} B; peak above the frame's inputs: replayed {peaks['1']} "
                f"B, per-stage {peaks['0']} B; capture {capture_s} s; planning frame "
                f"seconds with PREWARM=1 {plan_s['1']}, with 0 {plan_s['0']}")

            # (d) misses on the scene with room for spikes
            room = with_room(pts)
            clear_plans()
            N.reset_geoslot_hysteresis()
            with switches(SPLASHSURF_TPU_PREWARM="1"):
                frame(room, "1")
            interior = len(room) // 2
            collided = room.clone()
            collided[interior] = collided[interior + 1]
            # (label, frame, the mono frame's first outcome)
            misses = [("caps miss", spikes(room + 1e-6), "caps"),
                      ("density miss", collided + 2e-6, "density"),
                      ("grid miss", room + 2.0 * params.cube_size, "GridPlanMiss")]
            for j, (label, f, want) in enumerate(misses):
                state = plan_state()
                outcomes.clear()
                old = list(FG._GRAPHS.values())
                c0 = FG.STATS["captures"]
                mono = frame(f, "1")[0]
                seen, c1 = list(outcomes), FG.STATS["captures"]
                restore_plans(state)
                same(label, mono, frame(f, "0")[0])
                outcomes.clear()
                # the same frame again, warm on the plans its miss made (a
                # frame shifted by 1e-6 may miss the raster densities' tight
                # overflow capacity: 1e-6 moves tens of particles across bins)
                frame(f, "1")
                c2 = FG.STATS["captures"]
                # it runs a graph captured after the miss (a frame on the cold
                # grid after a grid miss is a mono frame too)
                fresh = all(g is not o for g in FG._GRAPHS.values() for o in old)
                del old
                if seen[0] != want or outcomes != [True] or not fresh or c2 == c0:
                    raise AssertionError(f"{label}: outcomes {seen}, then {outcomes}; "
                                         f"captures {c1 - c0}, then {c2 - c1}")
                log(f"  {label}: mono outcomes {seen} ({c1 - c0} captures), the per-stage "
                    f"mesh bit for bit; the next warm frame {outcomes} ({c2 - c1} captures) "
                    "on a fresh graph")
            log(f"  captures in phase 20 so far: {FG.STATS['captures']}, replays "
                f"{FG.STATS['replays']}, graphs live {FG.live()}")

            # (e) the encoded pull
            with switches(SPLASHSURF_TPU_PULL="encoded", SPLASHSURF_TPU_PREWARM="1"):
                clear_plans()
                N.reset_geoslot_hysteresis()
                frame(frames[0], "1")
                replays = FG.STATS["replays"]
                for f in frames[1:]:
                    enc = frame(f, "1")[0]
                if FG.STATS["replays"] - replays != N_FRAMES - 1:
                    raise AssertionError("the encoded warm frames did not replay")
            cs = float(params.cube_size)
            check_same_mesh("encoded mono / packed mono", enc.mesh, last_packed.mesh,
                            ordered=True, tol=pull_tol(last_packed.mesh, cs, True))
            if not np.array_equal(enc.mesh.triangles, last_packed.mesh.triangles):
                raise AssertionError("the encoded mono triangle list differs from the packed one")

            # (f) numpy frames on moved grid origins: a capture each, one
            # live graph, the card's memory bounded by one pool
            with switches(SPLASHSURF_TPU_PREWARM="1"):
                base, moved = moved_origin_frames(pt, pts.cpu().numpy(), params)
                clear_plans()
                N.reset_geoslot_hysteresis()
                planning_s = frame(base, "1")[1]
                secs, capture, reserved, pools = [], [], [], []
                for k, f in enumerate(moved, 1):
                    outcomes.clear()
                    captures = FG.STATS["captures"]
                    state = plan_state()
                    mono, dt, _ = frame(f, "1")
                    secs.append(dt)
                    capture.append(FG.STATS["capture_s"])
                    reserved.append(torch.cuda.memory_reserved())
                    pools.append(FG.pool_bytes())
                    got = (outcomes, FG.STATS["captures"] - captures, FG.live())
                    if got != ([True], 1, 1) or pools[-1] > 1.1 * pool:
                        raise AssertionError(f"moved origin {k}: (outcomes, captures, live "
                                             f"graphs) {got}, pool {pools[-1]} B against {pool}")
                growth = reserved[-1] - reserved[1]
                if growth >= pool:
                    raise AssertionError(f"moved origins: reserved memory grew by {growth} B "
                                         f"from frame 2 to frame {len(moved)}, one pool is "
                                         f"{pool} B")
                restore_plans(state)
                same(f"moved origin {len(moved)}", mono, frame(moved[-1], "0")[0])
                # the last origin again: replays of its graph
                restore_plans(state)
                replays, again = FG.STATS["replays"], []
                for _ in range(3):
                    outcomes.clear()
                    again.append(frame(moved[-1], "1")[1])
                    if outcomes != [True]:
                        raise AssertionError(f"the last moved origin again: {outcomes}")
                if (FG.STATS["replays"] - replays, FG.live()) != (3, 1):
                    raise AssertionError("the last moved origin did not replay its graph")
            log(f"  (f) {len(moved)} numpy frames on moved grid origins, one cell apart "
                f"(planning frame {planning_s} s): one capture and one live graph after each; "
                f"frame seconds (eager run and capture) {secs}; capture seconds {capture}; "
                f"pool bytes {pools} (one pool {pool}); memory reserved {reserved}, "
                f"growth from frame 2 to {len(moved)}: {growth} B; frame {len(moved)} "
                f"the per-stage mesh and densities bit for bit; the same frame replayed: "
                f"seconds {again}; this run's replayed tensor frames (a) median "
                f"{statistics.median(mono_s)} s ({ident})")
    finally:
        gp._try_warm_frame = try_warm
        clear_plans()
    log(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


def phase_array_inputs(pt, dev, pts, grid, params, ident):
    """Phase 21 (run after phase 17, on its 2M dam break and grid):
    array-like inputs go to the card by default, and give the tensor call's
    results bit for bit. Returns the K2 launches of its numpy density call."""
    from splashsurf_tpu_torch import kernels as K
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.aabb import aabb_from_points
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    h, m = params.compact_support_radius, params.particle_rest_mass
    pts_np = pts.cpu().numpy()
    log(f"phase 21: array inputs, {len(pts_np)} particles as numpy "
        f"({pts_np.nbytes / 1e6:.1f} MB)")

    def seconds(fn):
        times = []
        for _ in range(3):
            N.reset_geoslot_hysteresis()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)

    want, s_tensor = seconds(lambda: N.compute_particle_densities(pts, h, m))
    N.reset_geoslot_hysteresis()
    reset_launches(sk)
    got = N.compute_particle_densities(pts_np, h, m)
    torch.cuda.synchronize()
    launches = {"density_sweep": sk.density_sweep_cuda.launches}
    if launches["density_sweep"] == 0:
        raise AssertionError("the numpy density call did not launch K2")
    if got.device != pts.device or not torch.equal(got, want):
        raise AssertionError("the numpy density call differs from the tensor call")
    _, s_numpy = seconds(lambda: N.compute_particle_densities(pts_np, h, m))
    log(f"  compute_particle_densities: numpy input on {got.device}, bit-equal to the "
        f"tensor call, K2 launched {launches['density_sweep']}; median of 3: tensor "
        f"{s_tensor:.4f} s, numpy {s_numpy:.4f} s ({ident})")

    rng = np.random.default_rng(21)
    r_np = rng.uniform(0, 1.2 * h, 1 << 20).astype(np.float32)
    ijk_np = rng.integers(-1, max(grid.n_points) + 1, (1 << 16, 3))
    flat_np = rng.integers(0, grid.total_points, 1 << 16)
    box = pt.Aabb3d.from_points(pts_np).grow_uniformly(-0.05)
    checks = [
        ("cubic_kernel", lambda x: K.cubic_kernel(x, h), r_np),
        ("aabb_from_points", aabb_from_points, pts_np),
        ("Aabb3d.contains_points", box.contains_points, pts_np),
        ("UniformGrid.point_coordinates", grid.point_coordinates, ijk_np),
        ("UniformGrid.enclosing_cell", grid.enclosing_cell, pts_np),
        ("UniformGrid.flatten_point_index", grid.flatten_point_index, ijk_np),
        ("UniformGrid.flatten_cell_index", grid.flatten_cell_index, ijk_np),
        ("UniformGrid.unflatten_point_index", grid.unflatten_point_index, flat_np),
        ("UniformGrid.unflatten_cell_index", grid.unflatten_cell_index, flat_np),
        ("UniformGrid.point_in_grid", grid.point_in_grid, ijk_np),
        ("UniformGrid.cell_in_grid", grid.cell_in_grid, ijk_np),
        ("UniformGrid.is_boundary_point", grid.is_boundary_point, ijk_np),
        ("UniformGrid.is_boundary_cell", grid.is_boundary_cell, ijk_np),
    ]
    for name, fn, x in checks:
        got = fn(x)
        want = fn(torch.as_tensor(x, device=dev))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            if g.device != dev or g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{name}: the numpy call differs from the tensor call")
    log(f"  {len(checks)} helpers on numpy input: each result on {dev}, equal to the "
        "tensor call's")
    return launches


# the JAX package's summaries of the meshes the benchmark summarises at full
# width (written on the CPU by tests/test_torch_bench.py)
GOLDEN_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                           "torch_fullwidth.json")
BENCH_STAGES = ("density", "aabb", "normals", "mc")
# the scenes of the golden file that phase 22 runs: the default mode in f32
# and f64, frame 0 of --frames, the canyon of --sparse and the 13.35M dam
# break in f64. Its f32 mesh is not held: there the port's f32 level set
# (the kernels' and the plain versions' alike) puts 2 vertices more or less
# on the surface than the JAX package's, and each is 4-6 away from the f64
# mesh's counts (tools/fullwidth_count_probe.py), past the bar of equal counts
BENCH_SCENES = ("dam_break_2m_f32", "dam_break_2m_f64", "frames_2m_frame0", "canyon_8m_f32",
                "dam_break_13m_f64")


def run_bench(bench, argv):
    """``bench.main(argv)`` in-process: (its JSON line, its result); the
    line must be the only one it printed on stdout."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench.main(argv)
    lines = buf.getvalue().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != out["line"]:
        raise AssertionError(f"bench {argv} printed {lines}")
    return lines[0], out


def phase_bench(pt, ident):
    """Phase 22: the benchmark entry point, ``splashsurf_tpu_torch.bench.main``,
    in-process on the card, from no plan, with the frame's path switches
    unset: each scene of ``BENCH_SCENES`` with its arguments from
    ``tests/goldens/torch_fullwidth.json`` (the default mode in f32 and f64,
    ``--frames 6``, ``--sparse``, the 13.35M dam break in f64), then each
    ``--stage`` at 3 repeats. Each JSON line is logged with the card's name and power
    limit; each mesh summary must be within its bar (``bench.BARS``) of the
    JAX package's, on the JAX package's route; K1 and K2 must launch in the
    default mode and ``--frames``, K1 once per slab of each frame with
    ``--sparse``, K2 in ``--stage density`` and K1 in ``--stage mc``.
    Returns the K1 and K2 launches of the frame modes."""
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch import frame_graph as FG
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.ops import slab_sweep
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    log(f"phase 22: the benchmark entry point, python -m splashsurf_tpu_torch.bench ({ident})")
    t_phase = time.perf_counter()
    with open(GOLDEN_FILE) as f:
        goldens = json.load(f)
    totals = {"sweep_global": 0, "density_sweep": 0}
    runs = [(name, goldens[name]["argv"]) for name in BENCH_SCENES]
    runs += [(f"stage {s}", ["--stage", s, "--repeats", "3"]) for s in BENCH_STAGES]
    with switches(SPLASHSURF_TPU_MONO_FRAME=None, SPLASHSURF_TPU_PULL=None,
                  SPLASHSURF_TPU_DENSITY_CELLRASTER=None, SPLASHSURF_TPU_MC=None):
        for name, argv in runs:
            clear_plans()
            FG.drop()
            N.reset_geoslot_hysteresis()
            torch.cuda.synchronize()
            reset_launches(sk)
            t0 = time.perf_counter()
            line, out = run_bench(bench, argv)
            wall = time.perf_counter() - t0
            k1, k2 = sk.sweep_global_cuda.launches, sk.density_sweep_cuda.launches
            log(f"  {' '.join(argv)}: {line} ({ident}); K1 {k1}, K2 {k2}; {wall:.1f} s in all")
            if name.startswith("stage"):
                want = {"stage density": ("K2", k2), "stage mc": ("K1", k1)}.get(name)
                if want is not None and want[1] == 0:
                    raise AssertionError(f"bench {argv}: {want[0]} was not launched")
                continue
            g = goldens[name]
            args = bench.parse_args(argv)
            frames = 1 + (args.frames or args.repeats)
            log(f"    route {out['route']}, warm-up {out['warmup_s']:.4f} s, frame seconds "
                f"{out['times']}, peak device memory {out.get('peak_bytes')} B; mesh "
                f"{out['summary']['num_vertices']} vertices, "
                f"{out['summary']['num_triangles']} triangles")
            if out["route"] != g["route"]:
                raise AssertionError(f"bench {argv}: route {out['route']}, the JAX package's "
                                     f"{g['route']}")
            if out["route"] == "slab":
                n_slabs = slab_sweep.LAST_RUN["n_slabs"]
                if k1 != n_slabs * frames:
                    raise AssertionError(f"bench {argv}: K1 {k1} launches, want one per slab "
                                         f"of each frame, {n_slabs} x {frames}")
                log(f"    {n_slabs} slabs of {slab_sweep.LAST_RUN['slab_w']} cells: K1 once "
                    f"per slab of each of the {frames} frames")
            elif k1 < frames or k2 == 0:
                raise AssertionError(f"bench {argv}: K1 {k1}, K2 {k2} launches in {frames} "
                                     "frames")
            gaps = bench.summary_gaps(out["summary"], g["summary"], bench.BARS[g["bar"]])
            if gaps:
                raise AssertionError(f"bench {argv}: the mesh summary is outside the "
                                     f"{g['bar']} bars of the JAX package's: " + "; ".join(gaps))
            d = {k: out["summary"][k] - g["summary"][k]
                 for k in ("num_vertices", "num_triangles", "area", "volume")}
            log(f"    summary within the {g['bar']} bars of the JAX package's: differences {d}")
            totals["sweep_global"] += k1
            totals["density_sweep"] += k2
    log(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


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

    from splashsurf_tpu_torch import bench
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
    # the subdomain route's stage seconds, printed by phases 7, 15, 16 and 19,
    # are device seconds only with its stage clock synchronised
    from splashsurf_tpu_torch import subdomains as S

    S.enable_profile_sync(True)
    if sys.argv[1:] == ["--phase", "18"]:  # a quick look at phase 18 alone
        phase_plans(pt, pts, params, ident)
        return 0
    if sys.argv[1:] == ["--phase", "20"]:  # a quick look at phase 20 alone
        phase_mono(pt, pts, params, ident)
        return 0
    if sys.argv[1:] == ["--phase", "21"]:  # a quick look at phase 21 alone
        phase_array_inputs(pt, dev, pts, grid, params, ident)
        return 0
    if sys.argv[1:] == ["--phase", "23"]:  # a quick look at phase 23 alone
        phase_k5(pt, dev, pts, params, {}, ident)
        return 0
    if sys.argv[1:] == ["--phase", "24"]:  # a quick look at phase 24 alone
        phase_upload(dev, ident)
        return 0
    if sys.argv[1:] == ["--phase", "25"]:  # a quick look at phase 25 alone
        phase_k6(pt, dev, pts, params, {}, ident)
        return 0
    if sys.argv[1:] == ["--phase", "22"]:  # a quick look at phase 22 alone
        del pts
        phase_bench(pt, ident)
        return 0
    if sys.argv[1:] == ["--phase", "19"]:  # a quick look at phase 19 alone
        del pts
        phase_encoded(pt, dev, torch.as_tensor(bench.make_canyon(N_CANYON, RADIUS), device=dev),
                      pts_np, ident)
        return 0

    # --- 2. K1 ---------------------------------------------------------------
    N.reset_geoslot_hysteresis()
    rho = N.compute_particle_densities(pts, h, params.particle_rest_mass)
    values = params.particle_rest_mass / rho
    rasters, overflow = gs.rasterize_global(pts, values, grid, 2, hsc)
    log(f"phase 2: K1 on rasters {tuple(rasters[0].shape)}, "
        f"{overflow[0].shape[0]} overflow particles")
    for line in ptxas_report(sk, "sweep_global.cu", ("level_set_tiles", "occupancy_mask")):
        log("  ptxas " + line)
    log_block_geometry(sk, "sweep", len(sk.sweep_runs(hsc, hsc + 1, h / grid.cell_size)), hsc + 1)
    masks = check_masks(sk, "2M rasters", rasters[3])
    occupancy_report(sk, rasters[3], masks, hsc, hsc + 1, h / grid.cell_size, grid.n_points)
    del masks
    k1 = lambda: sk.sweep_global_cuda(*rasters, grid.cell_size, h, hsc, grid.n_points)
    p1 = lambda: sk.sweep_global_plain(*rasters, grid.cell_size, h, hsc, grid.n_points)
    out1 = k1()
    err1 = compare("K1 f32", out1, p1(), F32_TOL)
    ms1, pms1 = cuda_ms(k1, 10), cuda_ms(p1, 3)
    b1 = bound(nbytes(*rasters, out1), FLOPS_TERM *
               sweep_terms(rasters[3], sweep_offsets(hsc, hsc + 1, h / grid.cell_size),
                           grid.n_points))
    log(f"  K1 f32: kernel {ms1:.3f} ms (of which the mask pre-pass "
        f"{cuda_ms(lambda: sk.occupancy_masks_cuda(rasters[3]), 10):.4f} ms), plain {pms1:.3f} ms, "
        f"bound {b1[0]:.4f} ms ({b1[1]})")
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
    # edge rasters: points (13, 11, 45), none a multiple of the 2 x 4 x 32 tile
    cs, pad = grid.cell_size, hsc + 1
    n_edge = (13, 11, 45)
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        shape = (2,) + tuple(n + 2 * pad - 1 for n in n_edge)
        for name, r in edge_rasters(shape, dt, dev, cs, pad, seed=11):
            check_masks(sk, f"K1 {dt} {name}", r[3])
            compare(f"K1 {dt} {name} {shape}",
                    sk.sweep_global_cuda(*r, cs, h, hsc, n_edge),
                    sk.sweep_global_plain(*r, cs, h, hsc, n_edge), tol)
    kernels["sweep_global"] = dict(
        name="sweep_global", route="cuda",
        source="splashsurf_tpu_torch/csrc/sweep_global.cu",
        replaces="splashsurf_tpu/ops/splat_pallas.py:31",
        max_abs_err=err1, ms=ms1, plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
        library_ms=None,
    )

    # --- 3. K2 ---------------------------------------------------------------
    phase_k2(dev, pts, h, kernels)

    # --- 4. the main path at full size ---------------------------------------
    log(f"phase 4: reconstruct_surface, {n_main} particles")
    N.reset_geoslot_hysteresis()  # a geoslot scene: start from no recorded collision
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    stats0 = dict(SPECULATION_STATS)
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
    if sk.binned_sweep_cuda.launches != 0:
        raise AssertionError(f"geoslot frames launched K5 {sk.binned_sweep_cuda.launches} times")
    launches["occupancy_masks"] = check_mask_launches(sk, launches["sweep_global"])
    mesh = rec.mesh
    bad = pt.check_mesh_consistency(mesh.vertices, mesh.triangles)
    if bad is not None:
        raise AssertionError(f"mesh not closed/manifold: {bad}")
    if not np.isfinite(mesh.vertices).all() or mesh.num_triangles == 0:
        raise AssertionError("empty or non-finite mesh")
    warm = statistics.median(frame_s[1:])
    log(f"  mesh {mesh.num_vertices} vertices, {mesh.num_triangles} triangles, closed")
    log(f"  frame seconds {[round(s, 4) for s in frame_s]}; warm median {warm:.4f} s "
        f"= {n_main / warm / 1e6:.3f} Mparticles/s ({ident}); launches {launches}; "
        f"SPECULATION_STATS {stats_delta(stats0)}")
    dense_mesh = mesh

    # --- 23. K5, the binned densities' sweep -----------------------------------
    phase_k5(pt, dev, pts, params, kernels, ident)

    # --- 24. the staged upload of a numpy frame -------------------------------
    phase_upload(dev, ident)

    # --- 25. K6, the slot raster -----------------------------------------------
    phase_k6(pt, dev, pts, params, kernels, ident)

    # --- 18. warm frames on the frame plans ------------------------------------
    phase_plans(pt, pts, params, ident)

    # --- 20. the mono frame as one CUDA graph per plan set --------------------
    more = phase_mono(pt, pts, params, ident)
    for name, n in more.items():
        kernels[name]["launches"] += n
    log("  launches of phase 4 with phase 20's replays added: "
        + ", ".join(f"{k} {kernels[k]['launches']}" for k in more))

    # --- 17. the splat API, padded MC, the hysteresis, the kernel helpers -----
    more = phase_splat_api(pt, dev, pts, grid, hsc, params, kernels, ident)
    for name, n in more.items():
        kernels[name]["launches"] += n
    log("  launches of phase 4 with phase 17's added: "
        + ", ".join(f"{k} {kernels[k]['launches']}" for k in more))

    # --- 21. array-like inputs under the device rule ---------------------------
    more = phase_array_inputs(pt, dev, pts, grid, params, ident)
    for name, n in more.items():
        kernels[name]["launches"] += n
    log("  launches of phase 4 with phase 21's added: "
        + ", ".join(f"{k} {kernels[k]['launches']}" for k in more))

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
    canyon_mesh, canyon_warm = phase_canyon(pt, canyon, kernels, ident)
    phase_cross_subdomain(pt, dev, cross)

    # --- 9-10. the cell-raster densities and the sequence --------------------
    phase_k4(pt, dev, pts, grid, hsc, params, kernels)
    phase_sequence(pt, pts, params, kernels, ident)

    # --- 11-12. the CLI and the post-processing pipeline ---------------------
    del pts
    phase_cli(pt, pts_np, ident)
    phase_pipeline_cross(pt, dev)

    # --- 13-15. the slab route, the streamed subdomain route, the lists -------
    slab_counts = phase_slab(pt, dev, canyon, canyon_mesh, pts_np, dense_mesh, ident)
    phase_streaming(pt, canyon, canyon_mesh, ident)

    # --- 16. several shards in one process -----------------------------------
    more = phase_sharded(pt, dev, canyon, (canyon_mesh, canyon_warm), slab_counts, pts_np,
                         kernels, ident)
    for name, n in more.items():
        kernels[name]["launches"] += n
    log(f"  launches of phases 4 and 7 with phase 16's added: "
        + ", ".join(f"{k} {kernels[k]['launches']}" for k in more))

    # --- 19. the encoded mesh pull, edge-major marching cubes ----------------
    phase_encoded(pt, dev, canyon, pts_np, ident)
    del canyon, canyon_mesh
    phase_neighbors(pt, dev, cross, pts_np, ident)

    # --- 22. the benchmark entry point in every mode --------------------------
    more = phase_bench(pt, ident)
    for name, n in more.items():
        kernels[name]["launches"] += n
    log("  launches with phase 22's added: "
        + ", ".join(f"{k} {kernels[k]['launches']}" for k in more))

    print(ident, flush=True)
    names = ("sweep_global", "density_sweep", "splat_sweep", "pair_sweep", "binned_sweep",
             "slot_raster")
    print(json.dumps({"kernels": [kernels[k] for k in names]}), flush=True)
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
