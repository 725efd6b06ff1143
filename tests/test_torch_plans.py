"""The owner of the speculative frame plans (``splashsurf_tpu_torch.plans``):
``clear`` forgets what a short CPU script filled, ``note_failed_check``
turns failed checks into one miss, and no module below the pipeline imports
the layers above it to reach the plans."""

import ast
from pathlib import Path

import pytest
import torch

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import frame_graph, global_pipeline, plans
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)
from torch_mono import jittered_cube

PACKAGE = Path(pt.__file__).parent
TABLES = ("GRID_PLAN", "GRID_NOSPEC", "PENDING_NOSPEC", "WARMED", "DENSITY_PLAN", "MC_CAPS",
          "PULL_PLAN", "PULL_PLAN_ENC", "OVER_PLAN")


def test_clear_forgets_every_plan_and_count(monkeypatch):
    """Two frames of a small cube, the first a planning frame that prewarms
    (the mono frame on): every table but the no-speculation pair is filled
    by the pipeline, that pair by hand; a graph stands in for a captured
    one. ``clear`` empties them all, drops the graph and zeroes the
    counts."""
    monkeypatch.setenv("SPLASHSURF_TPU_MONO_FRAME", "1")
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "1")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")
    params = pt.Parameters.new_relative(0.025, 4.0, 1.5)
    cube = torch.as_tensor(jittered_cube(side=8))
    for _ in range(2):
        pt.reconstruct_surface(cube, params)
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "packed")
    pt.reconstruct_surface(cube + 1e-6, params)
    plans.PENDING_NOSPEC["key"] = "grid"
    plans.GRID_NOSPEC.add("key")
    monkeypatch.setitem(frame_graph._GRAPHS, "slot", object())
    assert all(getattr(plans, name) for name in TABLES), {
        name: len(getattr(plans, name)) for name in TABLES}
    assert plans.SPECULATION_STATS["frames"] > 0 and frame_graph.live() == 1
    plans.clear()
    assert not any(getattr(plans, name) for name in TABLES)
    assert set(plans.SPECULATION_STATS.values()) == {0} and frame_graph.live() == 0


@pytest.mark.parametrize("labels, flags, count, want", [
    (("density", "grid"), (True, True), True, None),
    ((), (), True, None),
    (("density", "grid"), (False, False), True, "grid"),
    (("density", "grid"), (True, False), True, "grid"),
    (("grid", "density"), (False, False), False, "grid"),
    (("density", "grid"), (False, True), True, "density"),
    (("grid", "density"), (True, False), False, "density"),
    (("grid", "grid"), (True, False), True, "grid"),
])
def test_a_failed_check_is_one_miss(monkeypatch, labels, flags, count, want):
    """Grid beats density; a density miss empties the density plans and
    drops every graph; ``count=False`` counts nothing."""
    plans.DENSITY_PLAN["key"] = {}
    monkeypatch.setitem(frame_graph._GRAPHS, "slot", object())
    before = dict(plans.SPECULATION_STATS)
    assert plans.note_failed_check(labels, flags, count=count) == want
    moved = {k: v - before[k] for k, v in plans.SPECULATION_STATS.items() if v != before[k]}
    assert moved == ({want + "_miss": 1} if want and count else {})
    assert bool(plans.DENSITY_PLAN) == (want != "density")
    assert frame_graph.live() == (want != "density")


def _imports(path: Path) -> set:
    """Every module that ``path`` imports, at its top or inside a function,
    by its dotted name (a ``from`` import also names each imported member)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


ABOVE = {"global_pipeline", "reconstruction", "frame_graph"}


@pytest.mark.parametrize("module, forbidden", [
    ("ops/global_sweep.py", ABOVE | {"neighbors"}),
    ("ops/splat_kernels.py", ABOVE | {"neighbors"}),
    ("neighbors.py", ABOVE),
    ("reconstruction.py", {"frame_graph"}),
    ("plans.py", {"neighbors", "ops", "global_pipeline", "reconstruction"}),
])
def test_no_module_imports_a_layer_above_it(module, forbidden):
    got = {n.removeprefix("splashsurf_tpu_torch.") for n in _imports(PACKAGE / module)}
    assert not {n for n in got if n.split(".")[0] in forbidden}, module


def test_plans_imports_only_the_standard_library_and_frame_graph():
    ours = {n for n in _imports(PACKAGE / "plans.py") if n.startswith("splashsurf_tpu_torch")}
    assert ours <= {"splashsurf_tpu_torch", "splashsurf_tpu_torch.frame_graph"}


def test_the_pipeline_counts_in_the_owners_dict():
    assert global_pipeline.SPECULATION_STATS is plans.SPECULATION_STATS
