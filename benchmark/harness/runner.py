"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, and the result's line.

The cell names a configuration (``configs/<config>.json``: the scene, its
size, its motion, the reconstruction's parameters, and ``env``, the
program's switches) and a traffic mix (``traffic/<mix>.json``: the
placement of the frames, the entry point that the window calls, the cycle
length, the warm-up frames, how many frames the check samples, and an
``env`` of its own). Scenes, motions, placements, entry points and metrics
are modules of their own (``scenes/``, ``motions/``, ``placements/``,
``entries/``, ``metrics/``), found by name (``harness.files``), and the
limits of the check are the cell's (``checks/<cell>.json``). The run's
``# host`` line (``harness.host``) says where the process ran and what the
host gave it.

Traffic is a closed loop with one frame in flight: the window calls the
program on frame i mod F of the cycle, i = 0, 1, ..., each call ending
with the mesh on the host, and starts frames while it is open; it ends
when the last one completes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from harness import host, scenes
from harness.files import HERE, ROOT, cell_files, load_json, load_module, switches
from reference.judge import judge
from reference.surface import Params

FORBIDDEN = ("jax", "jaxlib", "flax", "splashsurf_tpu", "bench")


@dataclasses.dataclass
class Run:
    """What the metrics read: the run's facts, and ``state`` for their own
    notes across their hooks."""

    config: dict
    device: torch.device
    positions: Callable  # k -> frame k's positions as a float32 tensor on the device
    n: list  # particles per cycle frame
    setup_s: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    frame_ids: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    held_bytes: int = 0
    trace: object = None
    routes: Optional[dict] = None  # cycle frame -> the program's route, where it says
    state: dict = dataclasses.field(default_factory=dict)


def load_metric(name: str):
    """The module ``metrics/<name>.py``."""
    return load_module("metrics", name)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """(entry, module) of the cell's end-to-end metrics (``trace`` False)
    or per-layer metrics (``trace`` True), in the order of the spec."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [(e, load_metric(e["name"])) for e in entries
            if "workloads" not in e or cell in e["workloads"]]


def program_params(pt, cfg: dict):
    """The program's parameters of a configuration (the CLI's terms)."""
    return pt.Parameters.new_relative(
        float(cfg["particle_radius"]), 2.0 * float(cfg["smoothing_length"]),
        float(cfg["cube_size"]), iso_surface_threshold=float(cfg["iso_surface_threshold"]),
        rest_density=float(cfg["rest_density"]), dtype=cfg["dtype"],
    )


def card_identity(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.splitlines()
        return out[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A sample of ``k`` of the window's frames, drawn from the seed
    (reservoir sampling): their cycle index, host mesh and densities. The
    densities are copied into buffers made before the window, so the
    sample holds the same device memory whichever frames it keeps."""

    def __init__(self, k: int, n: int, seed: int, device):
        self.k, self.rng = k, random.Random(seed)
        self.bufs = [torch.empty(n, dtype=torch.float32, device=device) for _ in range(k)]
        self.held = [None] * k
        self.seen = 0

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs)

    def offer(self, cycle_k: int, rec) -> None:
        i, self.seen = self.seen, self.seen + 1
        slot = i if i < self.k else self.rng.randrange(i + 1)
        if slot >= self.k:
            return
        rho = rec.particle_densities
        if rho is not None and rho.shape == self.bufs[slot].shape:
            self.bufs[slot].copy_(rho)
            rho = self.bufs[slot]
        self.held[slot] = (cycle_k, rec.mesh.vertices, rec.mesh.triangles, rho)


def run(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
        solve: Callable, t_start: float, *, elems: int = 1 << 24,
        slab_points: int = 1 << 26, log=None, context: Optional[Callable] = None,
        config_overrides: Optional[dict] = None, warmup: bool = True) -> dict:
    """One run of ``cell_name``: returns {"result": the result's line as a
    dict, "check": the lines of the compared numbers}. ``solve(frame)`` is
    the system under test; ``context(run)`` gives lines about the
    program's state for the log; ``config_overrides`` replaces keys of
    the configuration (tests run cells at small sizes)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, cfg, traffic = cell_files(spec, cell_name)
    cfg = {**cfg, **(config_overrides or {})}
    limits = load_json(HERE / "checks" / f"{cell_name}.json")["limits"]
    metrics = cell_metrics(spec, cell_name, trace)
    p = Params.from_config(cfg)

    # set-up: the cycle's frames from the seed, made on the device
    marks = [("imports", time.perf_counter())]
    placement = load_module("placements", traffic["placement"])
    frames, positions, held = placement.place(scenes.frames(cfg, traffic, seed, device), device)
    n = [int(f.shape[0]) for f in frames]
    r = Run(config=cfg, device=device, positions=positions, n=n)
    marks.append(("frames", time.perf_counter()))
    for k in traffic["warmup_frames"] if warmup else ():
        solve(frames[k])
        marks.append((f"warm-up frame {k}", time.perf_counter()))
    sample = Sample(int(traffic["check_frames"]), n[0], seed, device)
    r.held_bytes = held + sample.nbytes
    for _, m in metrics:
        if hasattr(m, "before_window"):
            m.before_window(r)
    hooks = [m.after_frame for _, m in metrics if hasattr(m, "after_frame")]
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function("window")
        span.__enter__()

    # the window
    cyc = int(traffic["cycle_frames"])
    attempted = failed = 0
    errors = []
    probe = host.Probe()
    probe.start()
    t0 = time.perf_counter()
    r.setup_s = t0 - t_start
    t_end = t0
    while True:
        ts = time.perf_counter()
        if ts - t0 >= seconds:
            break
        k = attempted % cyc
        attempted += 1
        try:
            rec = solve(frames[k])
        except Exception as e:  # a failed frame is counted, and the window goes on
            failed += 1
            errors.append(f"frame {k}: {type(e).__name__}: {e}")
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        r.latencies.append(t_end - ts)
        r.frame_ids.append(k)
        for hook in hooks:
            hook(r, k, rec)
        sample.offer(k, rec)
        del rec
    r.window_s = t_end - t0
    probe.stop()
    if prof is not None:
        _sync(device)
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    if device.type == "cuda":
        r.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if prof is not None:
        from harness.trace import from_profiler

        t = time.perf_counter()
        r.trace = from_profiler(prof)
        del prof
        kinds = {}
        for o in r.trace.device:
            kinds[o.kind] = kinds.get(o.kind, 0) + 1
        log(f"# trace: device operations {kinds}, {len(r.trace.host)} host events in the "
            f"window, read in {time.perf_counter() - t:.1f} s")
    for _, m in metrics:
        if hasattr(m, "after_window"):
            m.after_window(r)
    for e in errors[:5]:
        log(f"# failed {e}")
    log("# set-up, s: " + ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev in
                                    zip(marks, [t_start] + [t for _, t in marks])))
    log("# frame seconds: " + " ".join(f"{k}:{t:.3f}" for k, t in zip(r.frame_ids, r.latencies)))
    log(f"# window: {len(r.latencies)} frames completed of {attempted} started, "
        f"{r.window_s:.3f} s; peak allocated {r.peak_bytes} B, held by the harness "
        f"{r.held_bytes} B")
    if context is not None:
        for line in context(r):
            log(line)

    values = {}
    for e, m in metrics:
        v = m.read(r)
        if v is not None:
            values[e["name"]] = {"value": float(v), "unit": e["unit"]}
    log(host.line(torch.get_num_threads(), probe, r.window_s, r.latencies,
                  addresses=[f.ctypes.data for f in frames if hasattr(f, "ctypes")],
                  card=host.card_state(device.index or 0) if device.type == "cuda" else None,
                  extra={"metrics": {k: v["value"] for k, v in values.items()}}))

    # the check: the sampled frames against the reference
    kept = [h for h in sample.held if h is not None]
    sample.held = []
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {}
    t = time.perf_counter()
    for cycle_k, verts, tris, rho in kept:
        out = judge(positions(cycle_k), p, rho, verts, tris, elems=elems,
                    slab_points=slab_points)
        log(f"# check frame {cycle_k}: {json.dumps(out)}")
        for key, val in out["numbers"].items():
            worst[key] = max(worst.get(key, 0.0), val)
    log(f"# check: {len(kept)} frames in {time.perf_counter() - t:.1f} s")
    ok_numbers = bool(kept) and all(worst.get(key, math.inf) <= lim
                                    for key, lim in limits.items())
    check = {key: {"value": worst.get(key, math.inf), "limit": lim}
             for key, lim in limits.items()}
    check_lines = [f"check {key} {c['value']!r} limit {c['limit']!r}" for key, c in check.items()]
    if not kept:
        check_lines.append("check frames 0 limit 1")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": r.peak_bytes}
    result = {"correct": ok_numbers and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if r.trace is not None:
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        result["breakdown"] = {"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()}
    result["check"] = check
    return {"result": result, "check": check_lines, "run": r}


def program_for(spec: dict, cell_name: str) -> tuple:
    """Sets the cell's program switches (the ``env`` of its configuration,
    then of its traffic mix) in the environment, then imports the program:
    (the program, its parameters, the cell's entry point, the switches)."""
    _, cfg, traffic = cell_files(spec, cell_name)
    env = switches(cfg, traffic)
    os.environ.update({key: str(val) for key, val in env.items()})
    import splashsurf_tpu_torch as pt

    params = program_params(pt, cfg)
    return pt, params, load_module("entries", traffic["entry"]).solver(pt, params), env


def program_context(pt, params) -> Callable:
    """Lines about the program's state after the window: each cycle
    frame's grid and route (kept in ``run.routes`` too), the density
    formulation, the slab count, the speculation counters."""
    from splashsurf_tpu_torch import global_pipeline, neighbors
    from splashsurf_tpu_torch.ops import slab_sweep
    from splashsurf_tpu_torch.reconstruction import (
        _bucket_grid, choose_route, grid_for_reconstruction,
    )

    def lines(r: Run):
        out, r.routes = [], {}
        for k in sorted(set(r.frame_ids)):
            grid = _bucket_grid(grid_for_reconstruction(
                r.positions(k), params.particle_radius, params.compact_support_radius,
                params.cube_size))
            r.routes[k] = choose_route(params, grid)
            out.append(f"# frame {k}: grid {grid.n_cells} ({grid.total_cells} cells), "
                       f"route {r.routes[k]}")
        out.append(f"# density kind {neighbors.LAST_GATE.get('kind')}; slab run "
                   f"{ {k: v for k, v in slab_sweep.LAST_RUN.items() if k != 'rows'} }; "
                   f"speculation {dict(global_pipeline.SPECULATION_STATS)}")
        return out
    return lines


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    pt, params, solve, env = program_for(spec, args.workload)
    print(f"# device: {card_identity(device)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; cell {args.workload}, seed {args.seed}; program switches "
          f"{env}", file=sys.stderr)
    out = run(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
              solve, t_start, context=program_context(pt, params))
    found = forbidden_modules()
    if found:
        print(f"modules that the run may not load: {found}", file=sys.stderr)
        return 4
    for line in out["check"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0
