"""Scope-tree profiling (PyTorch port of ``splashsurf_tpu.profiling``).

Analog of the reference's ``profile!`` macro + ``Profiler``
(splashsurf_lib/src/profiling.rs:14-311): nested named scopes accumulate
wall time and call counts; ``write_to_string`` pretty-prints a percentage
tree. On the host side a scope optionally blocks on device work
(``block_on``: it synchronises the CUDA devices that hold the given
tensors) so device stages are attributed correctly; pair with
``device_trace`` (``torch.profiler``) for on-device detail.

Usage:
    with profile("reconstruct surface"):
        with profile("compute densities"):
            ...
    print(profiling.write_to_string())
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch


class _Scope:
    __slots__ = ("name", "total", "count", "children", "parent")

    def __init__(self, name: str, parent: Optional["_Scope"]):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "_Scope"] = {}
        self.parent = parent


class Profiler:
    """Per-thread scope stack; merged output across threads."""

    def __init__(self):
        self._local = threading.local()
        self._roots_lock = threading.Lock()
        self._roots: List[_Scope] = []
        self.enabled = True

    def _stack(self) -> List[_Scope]:
        if not hasattr(self._local, "stack"):
            root = _Scope("<root>", None)
            with self._roots_lock:
                self._roots.append(root)
            self._local.stack = [root]
        return self._local.stack

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        stack = self._stack()
        parent = stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = _Scope(name, parent)
            parent.children[name] = node
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_on_devices(block_on)
            node.total += time.perf_counter() - t0
            node.count += 1
            stack.pop()

    def reset(self):
        with self._roots_lock:
            self._roots.clear()
        if hasattr(self._local, "stack"):
            del self._local.stack

    def write_to_string(self) -> str:
        """Merged percentage tree over all threads (profiling.rs:178-293)."""
        with self._roots_lock:
            roots = list(self._roots)
        merged = _Scope("<root>", None)
        for r in roots:
            _merge(merged, r)
        lines: List[str] = []
        total = sum(c.total for c in merged.children.values()) or 1.0
        for child in merged.children.values():
            _write(child, lines, indent=0, parent_total=total)
        return "\n".join(lines)


def _merge(dst: _Scope, src: _Scope):
    dst.total += src.total
    dst.count += src.count
    for name, child in src.children.items():
        if name not in dst.children:
            dst.children[name] = _Scope(name, dst)
        _merge(dst.children[name], child)


def _write(node: _Scope, lines: List[str], indent: int, parent_total: float):
    pct = 100.0 * node.total / parent_total if parent_total > 0 else 100.0
    avg_ms = 1000.0 * node.total / max(node.count, 1)
    lines.append(
        f"{'  ' * indent}{node.name}: {pct:.2f}%, {node.total * 1000:.2f}ms avg "
        f"{avg_ms:.2f}ms ({node.count} call{'s' if node.count != 1 else ''})"
    )
    for child in node.children.values():
        _write(child, lines, indent + 1, node.total)


_PROFILER = Profiler()


def profile(name: str, block_on=None):
    """Context manager timing a named nested scope."""
    return _PROFILER.scope(name, block_on=block_on)


def write_to_string() -> str:
    return _PROFILER.write_to_string()


def reset():
    _PROFILER.reset()


def enable(on: bool = True):
    _PROFILER.enabled = on


class StageClock:
    """Seconds per stage of one run, the device synchronised at each stage
    boundary (the routes read counts back to the host anyway, so the few
    extra waits cost next to nothing). ``times`` maps each stage to its
    seconds, summed over the laps of that name. With ``track_peaks`` on a
    CUDA device, ``peaks`` maps each stage to the most device memory
    allocated during any of its laps (the allocator's peak statistics are
    reset at every boundary); otherwise it is None."""

    def __init__(self, device: torch.device, track_peaks: bool = False):
        self.device = device
        self.times: Dict[str, float] = {}
        self.peaks: Optional[Dict[str, int]] = None
        if track_peaks and device.type == "cuda":
            self.peaks = {}
            torch.cuda.reset_peak_memory_stats(device)
        self.t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        now = self._now()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        if self.peaks is not None:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.peaks[name] = max(self.peaks.get(name, 0), peak)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t = now


def block_on_devices(tensors) -> None:
    """Wait for the work queued on every CUDA device that holds one of
    ``tensors`` (a tensor, or a list, tuple or dict of them); CPU tensors
    need no wait."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU and, where present, CUDA
    activity) around a region and export it as a Chrome trace
    ``trace.json`` in ``log_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
