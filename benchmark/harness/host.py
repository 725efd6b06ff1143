"""The host under a run, for its ``# host`` line: where the process sits,
what it used, and the frame times of the window.

The line holds the CPUs the process may use and torch's thread count, the
CPU quota of its cgroup, the NUMA nodes of the CPUs and of the frames'
pages, the CPUs local to the card, the load average at the window's start
and end, the cores the process kept busy over the window, the card's clock
and power, the median, 90th percentile and quarter medians of the frame
times, and the run's metrics. A file that is missing or unreadable gives
null, and the line says so for the card. The process stays where it was
started: it is bound to no CPU and no node. Every file is read under
``root`` (``/`` on a machine; a folder of fake files in the tests)."""

from __future__ import annotations

import json
import os
import re
import resource
import statistics
import subprocess
from pathlib import Path
from typing import Optional

PCI = re.compile(r"^[0-9a-f]{4}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-9a-f]$")


def read(root: Path, rel: str) -> Optional[str]:
    """The text of ``root / rel``, or None where it is missing or unreadable."""
    try:
        return (root / rel).read_text()
    except OSError:
        return None


def cpulist(text: Optional[str]) -> Optional[set]:
    """The CPUs of a list such as ``0-3,8-11``, or None for no text."""
    if text is None:
        return None
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def fmt(cpus) -> str:
    """A set of CPUs as a list such as ``0-3,8-11``."""
    runs = []
    for c in sorted(cpus):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(str(a) if a == b else f"{a}-{b}" for a, b in runs)


def card_cpus(root: Path) -> str:
    """The CPUs local to the first card that the nvidia driver holds, in
    bus order (CUDA's order of identical cards), or why they are unknown."""
    try:
        cards = sorted(p.name for p in (root / "sys/bus/pci/drivers/nvidia").iterdir()
                       if PCI.match(p.name))
    except OSError:
        cards = []
    if not cards:
        return "not readable: no card under the nvidia driver"
    cpus = cpulist(read(root, f"sys/bus/pci/devices/{cards[0]}/local_cpulist"))
    if cpus is None:
        return f"not readable: no local_cpulist of card {cards[0]}"
    node = (read(root, f"sys/bus/pci/devices/{cards[0]}/numa_node") or "?").strip()
    return f"{fmt(cpus)} (card {cards[0]}, node {node})"


def quota(root: Path) -> Optional[float]:
    """The CPUs that the cgroup's quota allows (``cpu.max``), or None where
    there is no quota or no file."""
    text = read(root, "sys/fs/cgroup/cpu.max")
    if text is None or text.split()[0] == "max":
        return None
    q, period = text.split()[:2]
    return int(q) / int(period)


def cpu_nodes(root: Path) -> dict:
    """NUMA node -> its CPUs as a list (empty where ``/sys`` has no nodes)."""
    out = {}
    for d in sorted((root / "sys/devices/system/node").glob("node[0-9]*")):
        cpus = cpulist(read(root, str(d.relative_to(root) / "cpulist")))
        if cpus is not None:
            out[int(d.name[4:])] = fmt(cpus)
    return out


def page_nodes(root: Path, addresses) -> Optional[dict]:
    """NUMA node -> pages, over the mappings of ``/proc/self/numa_maps``
    that hold ``addresses`` (each mapping counted once), or None where the
    file cannot be read or holds none of them."""
    text = read(root, "proc/self/numa_maps")
    if text is None or not addresses:
        return None
    starts = []
    for line in text.splitlines():
        head, _, rest = line.partition(" ")
        try:
            starts.append((int(head, 16), rest))
        except ValueError:
            continue
    starts.sort()
    found, out = set(), {}
    for addr in addresses:
        hits = [s for s in starts if s[0] <= addr]
        if not hits or hits[-1][0] in found:
            continue
        found.add(hits[-1][0])
        for m in re.finditer(r"\bN(\d+)=(\d+)", hits[-1][1]):
            out[int(m.group(1))] = out.get(int(m.group(1)), 0) + int(m.group(2))
    return out or None


class Probe:
    """The load average and the process's CPU seconds at the window's
    start (``start``) and end (``stop``)."""

    def __init__(self, root: Path = Path("/")):
        self.root = root
        self.at = {}

    def _read(self) -> tuple:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        load = read(self.root, "proc/loadavg")
        return (load.split()[0] if load else None), ru.ru_utime + ru.ru_stime

    def start(self) -> None:
        self.at["start"] = self._read()

    def stop(self) -> None:
        self.at["stop"] = self._read()

    def deltas(self, window_s: float) -> dict:
        if "start" not in self.at or "stop" not in self.at or window_s <= 0:
            return {}
        (load_a, cpu_a), (load_b, cpu_b) = self.at["start"], self.at["stop"]
        return {"loadavg": [load_a, load_b],
                "process_cores": round((cpu_b - cpu_a) / window_s, 3)}


def card_state(index: int = 0) -> Optional[str]:
    """The card's SM clock, its maximum, its power draw and limit, as
    ``nvidia-smi`` reads them now, or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
            check=True).stdout.splitlines()
        return out[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def frame_ms(latencies: list) -> Optional[dict]:
    """Median, 90th percentile and the medians of each quarter of the
    window's frame times, in ms; None for fewer than 4 frames."""
    n = len(latencies)
    if n < 4:
        return None
    ms = [1e3 * t for t in latencies]
    return {"median": round(statistics.median(ms), 3),
            "p90": round(statistics.quantiles(ms, n=10)[-1], 3),
            "quarter_medians": [round(statistics.median(ms[i * n // 4:(i + 1) * n // 4]), 3)
                                for i in range(4)]}


def line(threads: int, probe: Probe, window_s: float, latencies: list,
         root: Path = Path("/"), addresses=(), card: Optional[str] = None,
         extra: Optional[dict] = None) -> str:
    """The run's ``# host`` line: one JSON object."""
    info = {"cpus": fmt(os.sched_getaffinity(0)), "threads": threads,
            "quota_cpus": quota(root), "cpu_nodes": cpu_nodes(root),
            "card_cpus": card_cpus(root), "frame_page_nodes": page_nodes(root, addresses)}
    info.update(probe.deltas(window_s))
    info["frame_ms"] = frame_ms(latencies)
    info["card"] = card
    info.update(extra or {})
    return "# host " + json.dumps(info)
