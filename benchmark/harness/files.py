"""The benchmark's files, found by name: data files (``load_json``) and
small modules (``load_module(kind, name)``: ``<kind>/<name>.py`` under the
benchmark's folder, such as ``metrics/throughput.py``, ``scenes/canyon.py``
or ``placements/host.py``). A new scene, motion, placement, entry or
metric is a new file; no file of the harness names it."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, cell_name: str) -> tuple:
    """(the cell's entry, its configuration, its traffic mix)."""
    cell = next(w for w in spec["workloads"] if w["name"] == cell_name)
    centry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT / centry["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def switches(cfg: dict, traffic: dict) -> dict:
    """The program's switches of a cell: the ``env`` of its configuration,
    then of its traffic mix."""
    return {**cfg.get("env", {}), **traffic.get("env", {})}


def command_switches(argv: list) -> dict:
    """The program's switches of the cell that a command line names
    (``--workload <cell>``), as strings; {} where it names none. ``run.py``
    sets them before torch loads, as a user sets them before starting the
    process: OpenMP reads its settings (``OMP_WAIT_POLICY``,
    ``OMP_NUM_THREADS``) when it loads."""
    try:
        _, cfg, traffic = cell_files(load_json(ROOT / "BENCHMARK.json"),
                                     argv[argv.index("--workload") + 1])
    except (ValueError, IndexError, StopIteration, OSError, KeyError):
        return {}
    return {key: str(val) for key, val in switches(cfg, traffic).items()}


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
