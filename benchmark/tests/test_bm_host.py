"""The run's ``# host`` line (``harness.host``) on fake ``/sys`` and
``/proc`` trees, with files present, missing and unreadable; and the
cell's program switches, which ``run.py`` sets before torch loads."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bm_small import N_SMALL, program, spec
from harness import host, runner
from harness.files import command_switches

BENCH = Path(__file__).resolve().parent.parent
BUS = "0000:1b:00.0"


def fake_sys(root: Path, local="0-3") -> Path:
    (root / "sys/bus/pci/drivers/nvidia" / BUS).mkdir(parents=True)
    (root / "sys/bus/pci/drivers/nvidia/module").mkdir()  # not a card
    dev = root / "sys/bus/pci/devices" / BUS
    dev.mkdir(parents=True)
    if local is not None:
        (dev / "local_cpulist").write_text(local + "\n")
    (dev / "numa_node").write_text("0\n")
    for n, cpus in ((0, "0-3"), (1, "4-7")):
        d = root / f"sys/devices/system/node/node{n}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpus + "\n")
    return root


def test_cpulist_round_trip():
    assert host.cpulist("0-3,8-11,15\n") == {0, 1, 2, 3, 8, 9, 10, 11, 15}
    assert host.fmt({0, 1, 2, 3, 8, 9, 10, 11, 15}) == "0-3,8-11,15"
    assert host.cpulist(None) is None and host.fmt(set()) == ""


@pytest.mark.parametrize("case, want", [
    ("readable", f"0-3 (card {BUS}, node 0)"),
    ("no driver", "not readable: no card under the nvidia driver"),
    ("no local_cpulist", f"not readable: no local_cpulist of card {BUS}"),
    ("unreadable local_cpulist", f"not readable: no local_cpulist of card {BUS}"),
])
def test_card_cpus(tmp_path, case, want):
    if case == "no driver":
        root = tmp_path
    elif case == "readable":
        root = fake_sys(tmp_path)
    else:
        root = fake_sys(tmp_path, local=None)
        if case == "unreadable local_cpulist":
            (root / "sys/bus/pci/devices" / BUS / "local_cpulist").mkdir()  # reading it fails
    assert host.card_cpus(root) == want


def test_quota_and_nodes(tmp_path):
    cg = tmp_path / "sys/fs/cgroup"
    cg.mkdir(parents=True)
    assert host.quota(tmp_path) is None
    (cg / "cpu.max").write_text("max 100000\n")
    assert host.quota(tmp_path) is None
    (cg / "cpu.max").write_text("400000 100000\n")
    assert host.quota(tmp_path) == 4.0
    assert host.cpu_nodes(fake_sys(tmp_path)) == {0: "0-3", 1: "4-7"}
    assert host.cpu_nodes(tmp_path / "nothing") == {}


def test_page_nodes(tmp_path):
    (tmp_path / "proc/self").mkdir(parents=True)
    (tmp_path / "proc/self/numa_maps").write_text(
        "55d000000000 default file=/usr/bin/python3 mapped=10 N0=10\n"
        "7f0000000000 default anon=38912 dirty=38912 N0=30000 N1=8912 kernelpagesize_kB=4\n"
        "7f0010000000 default anon=100 dirty=100 N1=100 kernelpagesize_kB=4\n")
    # two frames in the first anonymous mapping count it once
    got = host.page_nodes(tmp_path, [0x7F0000000000 + 64, 0x7F0000100000, 0x7F0010000040])
    assert got == {0: 30000, 1: 9012}
    assert host.page_nodes(tmp_path, []) is None
    assert host.page_nodes(tmp_path / "nothing", [0x7F0000000000]) is None


def test_probe(tmp_path):
    (tmp_path / "proc").mkdir()
    probe = host.Probe(tmp_path)
    (tmp_path / "proc/loadavg").write_text("0.25 0.50 0.40 1/100 1234\n")
    probe.start()
    (tmp_path / "proc/loadavg").write_text("1.75 0.50 0.40 1/100 1234\n")
    probe.stop()
    d = probe.deltas(2.0)
    assert d["loadavg"] == ["0.25", "1.75"] and d["process_cores"] >= 0
    missing = host.Probe(tmp_path / "nothing")
    missing.start()
    missing.stop()
    assert missing.deltas(1.0)["loadavg"] == [None, None]
    assert host.Probe(tmp_path).deltas(1.0) == {}  # never started


def test_the_line_is_one_json_object(tmp_path):
    probe = host.Probe(fake_sys(tmp_path))
    probe.start()
    probe.stop()
    ms = [0.05, 0.06, 0.05, 0.07, 0.05, 0.05, 0.09, 0.05]
    text = host.line(4, probe, 1.0, ms, root=tmp_path, extra={"metrics": {"throughput": 2.0}})
    assert text.startswith("# host ") and "\n" not in text
    info = json.loads(text[len("# host "):])
    assert info["threads"] == 4 and info["quota_cpus"] is None
    assert info["card_cpus"].startswith("0-3 (card") and info["cpu_nodes"] == {"0": "0-3",
                                                                                 "1": "4-7"}
    assert info["frame_ms"]["median"] == 50.0
    assert info["frame_ms"]["quarter_medians"] == [55.0, 60.0, 50.0, 70.0]
    assert info["metrics"] == {"throughput": 2.0}
    assert host.frame_ms(ms[:3]) is None


def test_a_run_logs_one_host_line():
    import splashsurf_tpu_torch as pt

    lines = []
    small = {"n_particles_target": N_SMALL["dam_break_13m"]}
    cfg = {**runner.load_json(runner.HERE / "configs" / "dam_break_13m.json"), **small}
    out = runner.run(spec(), "dam_break_13m.host_flow", 2**31 + 17, 0.5, False,
                     torch.device("cpu"), program(runner.program_params(pt, cfg)),
                     time.perf_counter(), elems=1 << 18, slab_points=1 << 16,
                     log=lines.append, config_overrides=small)
    assert out["result"]["correct"], out["check"]
    found = [ln for ln in lines if ln.startswith("# host ")]
    assert len(found) == 1
    info = json.loads(found[0][len("# host "):])
    assert info["threads"] == torch.get_num_threads()
    assert info["metrics"]["throughput"] > 0
    if not torch.cuda.is_available():
        assert info["card_cpus"].startswith("not readable") and info["card"] is None


def test_command_switches():
    assert command_switches(["--workload", "dam_break_13m.host_flow", "--seed", "1"]) == \
        {"OMP_WAIT_POLICY": "ACTIVE"}
    assert command_switches(["--workload", "dam_break_13m.device_flow"]) == {}
    assert command_switches(["--workload", "no_such_cell"]) == {}
    assert command_switches(["--seed", "1"]) == {}


def test_run_sets_the_switches_before_torch_loads():
    # an import hook notes the environment at the moment run.py imports torch
    code = (
        "import json, os, runpy, sys\n"
        "seen = {}\n"
        "class Hook:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'torch' and not seen:\n"
        "            seen['policy'] = os.environ.get('OMP_WAIT_POLICY')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Hook())\n"
        "sys.path.insert(0, 'benchmark')  # as python puts a script's folder first\n"
        "sys.argv = ['run.py', '--workload', 'dam_break_13m.host_flow', '--seed', '1',\n"
        "            '--seconds', '1']\n"
        "try:\n"
        "    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    seen['code'] = e.code\n"
        "print(json.dumps(seen))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "OMP_WAIT_POLICY"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # the run stops at its look for a card
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=BENCH.parent, env=env)
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["policy"] == "ACTIVE" and seen["code"] != 0
