"""The harness finds every piece by name: each scene, motion, placement,
entry point and metric that the data names is a file of its own, and the
program's switches of a configuration and a traffic mix reach the
environment before the program is imported."""

import os

import pytest

from bm_small import spec
from harness import runner
from harness.files import HERE, load_json, load_module


def test_every_named_piece_is_a_file():
    s = spec()
    for c in s["configs"]:
        cfg = load_json(runner.ROOT / c["file"])
        assert callable(load_module("scenes", cfg["scene"]).make)
        assert callable(load_module("motions", cfg["motion"]["field"]).along_axis)
    for w in s["workloads"]:
        traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        assert callable(load_module("placements", traffic["placement"]).place)
        assert callable(load_module("entries", traffic["entry"]).solver)
        assert (HERE / "checks" / f"{w['name']}.json").is_file()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(load_module("metrics", m["name"]).read)


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no scene 'no_such_scene'"):
        load_module("scenes", "no_such_scene")


def test_switches_reach_the_environment(monkeypatch):
    cell, cfg, traffic = runner.cell_files(spec(), "dam_break_13m.host_flow")
    cfg = {**cfg, "env": {"BM_TEST_A": "config", "BM_TEST_B": 1}}
    traffic = {**traffic, "env": {"BM_TEST_A": "traffic"}}
    monkeypatch.setattr(runner, "cell_files", lambda s, name: (cell, cfg, traffic))
    for key in ("BM_TEST_A", "BM_TEST_B"):
        monkeypatch.delenv(key, raising=False)
    pt, params, solve, env = runner.program_for({}, "dam_break_13m.host_flow")
    assert env == {"BM_TEST_A": "traffic", "BM_TEST_B": 1}
    assert os.environ["BM_TEST_A"] == "traffic" and os.environ["BM_TEST_B"] == "1"
    assert callable(solve) and params.particle_radius == pytest.approx(0.011)
