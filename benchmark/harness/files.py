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
