"""Runs of the harness on the CPU at a small size, for the tests."""

import time

import torch

from harness import runner

N_SMALL = {"dam_break_13m": 4000, "canyon_13m": 6000}

# The canyon's cell waits outside BENCHMARK.json (its runs drift with the
# host: PERF.md, Open questions); its files stay, and the tests drive it.
WAITING = {
    "configs": [{"name": "canyon_13m", "file": "benchmark/configs/canyon_13m.json"}],
    "workloads": [{"name": "canyon_13m.host_flow", "config": "canyon_13m",
                   "traffic": "host_flow", "chips": 1}],
}


def spec() -> dict:
    """BENCHMARK.json with the waiting cell."""
    s = runner.load_json(runner.ROOT / "BENCHMARK.json")
    for key, entries in WAITING.items():
        names = {e["name"] for e in s[key]}
        s[key] = s[key] + [e for e in entries if e["name"] not in names]
    return s


def small_run(cell: str, solve_for, seconds: float = 1.0, seed: int = 2**31 + 99,
              trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU at a small size. ``solve_for(params)``
    gives the system under test for the program's parameters."""
    import splashsurf_tpu_torch as pt

    config = cell.split(".")[0]
    cfg = {**runner.load_json(runner.HERE / "configs" / f"{config}.json"),
           "n_particles_target": N_SMALL[config]}
    params = runner.program_params(pt, cfg)
    return runner.run(spec(), cell, seed, seconds, trace, torch.device("cpu"),
                      solve_for(params), time.perf_counter(), elems=1 << 18,
                      slab_points=1 << 16, log=lambda msg: None,
                      config_overrides={"n_particles_target": N_SMALL[config]})


def program(params):
    import splashsurf_tpu_torch as pt

    return lambda frame: pt.reconstruct_surface(frame, params, device="cpu")
