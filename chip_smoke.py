#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``splashsurf_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

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
     support 4r, cube 1.5r, iso 0.6): one cold frame and three more; the mesh
     must be closed and manifold and both kernels must have launched;
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
     cell-raster densities (``SPLASHSURF_TPU_DENSITY_CELLRASTER=1``): every
     frame without raster overflow takes them (K4 launched once, K2 not at
     all, one mask pre-pass for each K1 and K4 launch), each mesh is closed and equals a frame-at-a-time run, and the
     first frame agrees with the legacy densities (rho rtol 1e-5, equal
     counts, vertices within 1e-4); per-frame seconds pipelined and frame at
     a time, and the stage split of both density formulations;
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
FLOPS_D2 = {"density_sweep": 9, "pair_sweep": 12}
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
    for fn in (sk.sweep_global_cuda, sk.density_sweep_cuda, sk.splat_sweep_cuda,
               sk.pair_sweep_cuda, sk.occupancy_masks_cuda, sk.bin_occupancy_cuda):
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
    import bench
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


def check_same_mesh(name, a, b, ordered, tree=None, same_counts=True):
    """Equal counts (unless ``same_counts`` is False) and vertices within
    1e-4: position by position when both lists share an order, else by
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
    if vdiff >= 1e-4:
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


def phase_k4(pt, dev, pts, grid, hsc, params, kernels):
    """Phase 9: K4 against its plain version on the meta rasters of the 2M
    dam break (f32, timed with its mask pre-pass) and of a 20K dam break in
    f64, on occupied query slots; the kernel writes exactly 0 on the empty
    ones. Then edge rasters in f32 and f64."""
    import bench
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
    from splashsurf_tpu_torch.global_pipeline import MeshPull
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
        verts, tris = gs.mesh_from_level_set(ls, grid, params.iso_surface_threshold)
        lap("marching cubes")
        MeshPull(verts, tris).resolve()
        lap("pull")
        runs.append(t)
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def rel_err(rho, truth):
    return float(((rho.double() - truth).abs() / truth).max())


def compare_legacy(pt, frame, params, cell):
    """Frame 0 with the cell-raster densities (``cell``) against the legacy
    densities (switch "0").

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
    log(f"  frame 0 f64, cell-raster / legacy ({kind}) densities: rho max relative "
        f"difference {rel_err(cell64.particle_densities, truth.particle_densities):.3e}")
    check_same_mesh("frame 0 f64, cell-raster / legacy", cell64.mesh, truth.mesh, ordered=True)
    rho64 = truth.particle_densities
    e_cell = rel_err(cell.particle_densities, rho64)
    e_leg = rel_err(legacy.particle_densities, rho64)
    log(f"  frame 0 f32, rho max relative error against the f64 densities: cell-raster "
        f"{e_cell:.3e}, legacy {e_leg:.3e}; between them "
        f"{rel_err(cell.particle_densities, legacy.particle_densities.double()):.3e}")
    if e_cell > max(1e-5, 2 * e_leg):
        raise AssertionError(f"cell-raster densities off by {e_cell:.3e} (legacy {e_leg:.3e})")
    check_same_mesh("frame 0 f32, cell-raster / legacy", cell.mesh, legacy.mesh, ordered=False,
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
        reset_launches(sk)
        record = []

        def recording():
            for f in frames:
                yield f
                record.append((N.LAST_GATE.get("kind"), sk.pair_sweep_cuda.launches,
                               sk.density_sweep_cuda.launches))

        seq, gaps_pipe = timed_sequence(pt.reconstruct_sequence(recording(), params))
        launches = sk.pair_sweep_cuda.launches
        masks = check_mask_launches(sk, sk.sweep_global_cuda.launches + launches)
        took, prev = 0, (0, 0)
        for i, ((kind, k4, k2), n_over) in enumerate(zip(record, over)):
            step, prev = (k4 - prev[0], k2 - prev[1]), (k4, k2)
            if n_over == 0:
                if kind != "cellraster" or step != (1, 0):
                    raise AssertionError(
                        f"frame {i} has no raster overflow but took {kind} with "
                        f"(K4, K2) launches {step}"
                    )
                took += 1
        if took == 0:
            raise AssertionError("no frame of the sequence took the cell-raster densities")
        kernels["pair_sweep"]["launches"] = launches
        for i, rec in enumerate(seq):
            bad = pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles)
            if bad is not None or rec.mesh.num_triangles == 0:
                raise AssertionError(f"frame {i}: mesh not closed/manifold or empty: {bad}")

        os.environ["SPLASHSURF_TPU_PIPELINE"] = "0"
        single, gaps_single = timed_sequence(pt.reconstruct_sequence(frames, params))
        for i, (a, b) in enumerate(zip(seq, single)):
            check_same_mesh(f"frame {i}, sequence / frame at a time", a.mesh, b.mesh, ordered=True)

        compare_legacy(pt, frames[0], params, seq[0])
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
    import bench
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
    import bench
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
        f"= {n_main / warm / 1e6:.3f} Mparticles/s ({ident}); launches {launches}")
    dense_mesh = mesh

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
    del canyon, canyon_mesh
    phase_neighbors(pt, dev, cross, pts_np, ident)

    print(ident, flush=True)
    names = ("sweep_global", "density_sweep", "splat_sweep", "pair_sweep")
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
