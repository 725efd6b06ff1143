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

A scope is also a span. While a ``torch.profiler`` trace runs, it records
a host event under its name (``_RecordFunctionFast``, a "cpu_op"), so the
trace holds it beside the device's kernels on one clock; a
``record_function`` annotation would also put a copy of the span on the
device's timeline, where it reads as device work. While the recorder is on
(``record_spans``), it adds its host seconds and, on a card, the seconds
of the current stream between a CUDA event at its entry and one at its
exit to the totals of its name (``span_totals``); it never synchronises.
Off, both cost one flag check each. The dense route's reads of the card go
through ``read_back`` / ``to_host``, which count them in ``COUNTERS``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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
        span = _NO_SPAN
        if _RECORDER is not None or _autograd_profiler._is_profiler_enabled:
            span = _Span(name)
        with span:
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


# The group of the spans named "redo <plan>" in ``span_totals``: those that
# no other redo span encloses, so that nested repeats count once.
REDO = "redo"


class _Recorder:
    """The span totals of one recording (``record_spans``): per name, the
    count, host seconds and device seconds of the spans that no span of the
    same name encloses, and under ``REDO`` those of the redo spans that no
    other redo span encloses. On a CUDA device a span's device seconds are
    the current stream's from a CUDA event recorded at its entry to one at
    its exit: from the end of the work queued before the span to the end of
    the work queued inside it, idle time included. A span entered while the
    stream is being captured into a CUDA graph records no event and adds no
    device time. Elsewhere device seconds are host seconds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.timed = device.type == "cuda"
        self.totals: Dict[str, List[float]] = {}
        self.events: list = []  # (keys, start, end) not yet resolved
        self.lock = threading.Lock()
        self.local = threading.local()

    def _open(self) -> List[str]:
        if not hasattr(self.local, "open"):
            self.local.open = []
        return self.local.open

    def enter(self, name: str):
        open_ = self._open()
        keys = [] if name in open_ else [name]
        if name.startswith(REDO + " ") and not any(n.startswith(REDO + " ") for n in open_):
            keys.append(REDO)
        open_.append(name)
        start = None
        if self.timed and keys and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        return keys, start, time.perf_counter()

    def exit(self, token) -> None:
        keys, start, t0 = token
        host = time.perf_counter() - t0
        self._open().pop()
        end = None
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        with self.lock:
            for key in keys:
                tot = self.totals.setdefault(key, [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += host
                if not self.timed:
                    tot[2] += host
            if end is not None:
                self.events.append((keys, start, end))

    def read(self) -> Dict[str, Dict[str, float]]:
        with self.lock:
            events, self.events = self.events, []
            for keys, start, end in events:
                s = start.elapsed_time(end) / 1e3
                for key in keys:
                    self.totals[key][2] += s
            return {k: {"count": int(c), "host_s": h, "device_s": d}
                    for k, (c, h, d) in self.totals.items()}


class _Span:
    """What a scope adds while a trace or the recorder is on: the trace's
    host event, the recorder's totals."""

    __slots__ = ("name", "recorder", "annotation", "token")

    def __init__(self, name: str):
        self.name = name
        self.recorder = _RECORDER
        self.annotation = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch._C._profiler._RecordFunctionFast(self.name)
            self.annotation.__enter__()
        if self.recorder is not None:
            self.token = self.recorder.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.recorder is not None:
            self.recorder.exit(self.token)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()
_RECORDER: Optional[_Recorder] = None
_LAST_RECORDER: Optional[_Recorder] = None


def record_spans(on: bool, device=None) -> None:
    """Turn the span recorder on, with fresh totals, or off (its totals
    stay readable). ``device``: whose current stream times the spans, by
    default the current CUDA device where CUDA is available, else the CPU
    (device seconds = host seconds)."""
    global _RECORDER, _LAST_RECORDER
    if not on:
        _RECORDER = None
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _RECORDER = _LAST_RECORDER = _Recorder(device)


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"count", "host_s", "device_s"}} of the current recording, or
    of the last one where the recorder is off; ``REDO`` is the group of the
    redo spans (``_Recorder``). On a card, synchronise first: the device
    seconds are read from the spans' CUDA events, which must have
    completed."""
    return {} if _LAST_RECORDER is None else _LAST_RECORDER.read()


# Program counters, always on. "readbacks": the reads of the card by the
# host on the dense route (``read_back``), each a wait for the device.
COUNTERS: Dict[str, int] = {"readbacks": 0}
_COUNTERS_LOCK = threading.Lock()


@contextlib.contextmanager
def read_back():
    """A read of the device by the host: counted in
    ``COUNTERS["readbacks"]``, and a "read back" span."""
    with _COUNTERS_LOCK:
        COUNTERS["readbacks"] += 1
    with profile("read back"):
        yield


def redo_span(plan: str, attempt: int):
    """The span of an attempt that a miss of ``plan`` makes the program
    repeat: "redo <plan>" from the second attempt (``attempt`` > 0) on,
    none around the first."""
    return profile(f"{REDO} {plan}") if attempt else _NO_SPAN


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x.cpu()`` as one counted read-back (``read_back``)."""
    with read_back():
        return x.cpu()


class StageClock:
    """Seconds per stage of one run, the device synchronised at each stage
    boundary unless ``sync`` is False (then the seconds are those of the
    host's dispatch, and work queued on the device lands in whichever later
    stage waits for it). ``times`` maps each stage to its seconds, summed
    over the laps of that name. With ``track_peaks`` on a CUDA device,
    ``peaks`` maps each stage to the most device memory allocated during
    any of its laps (the allocator's peak statistics are reset at every
    boundary); otherwise it is None."""

    def __init__(self, device: torch.device, track_peaks: bool = False, sync: bool = True):
        self.device = device
        self.sync = sync
        self.times: Dict[str, float] = {}
        self.peaks: Optional[Dict[str, int]] = None
        if track_peaks and device.type == "cuda":
            self.peaks = {}
            torch.cuda.reset_peak_memory_stats(device)
        self.t = self._now()

    def _now(self) -> float:
        if self.sync and self.device.type == "cuda":
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
