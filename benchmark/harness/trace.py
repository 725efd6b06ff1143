"""The profiler's trace of a run's window, reduced to what the per-layer
metrics read: the device's operations (kernels, copies, sets) and the
host's activity, on one clock.

The window is a ``record_function`` span of the harness ("window"); its
start and end in the trace bound everything. ``busy_ns`` is the union of
the device's operation intervals within it, never their sum, so that
overlapping operations count once."""

from __future__ import annotations

import dataclasses

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "window"


@dataclasses.dataclass
class Op:
    kind: str
    name: str
    start: int  # ns
    end: int  # ns


def union_ns(intervals, lo: int, hi: int) -> int:
    """The length of the union of the (start, end) intervals, clipped to
    [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle gaps (start, end) of [lo, hi] that no interval covers."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    out, at = [], lo
    for s, e in spans:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


class Trace:
    """The window's device operations and host events."""

    def __init__(self, ops: list, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.device = [o for o in ops if o.kind in DEVICE_KINDS and o.end > lo and o.start < hi]
        self.host = sorted((o for o in ops if o.kind in HOST_KINDS and o.name != WINDOW),
                           key=lambda o: o.start)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_ns([(o.start, o.end) for o in self.device], self.lo, self.hi) * 1e-9

    def seconds(self, match) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        return sum(min(o.end, self.hi) - max(o.start, self.lo)
                   for o in self.device if match(o.name)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for o in self.device:
            by[o.name] = by.get(o.name, 0) + min(o.end, self.hi) - max(o.start, self.lo)
        return [[name[:160], ns * 1e-9] for name, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, labelled: int = 2000) -> list:
        """Idle time by what the host was doing: each of the ``labelled``
        longest gaps goes to the innermost host event that spans its middle
        (the latest-starting one), the rest to "(gaps under <length> us)";
        the ``n`` largest totals."""
        gs = sorted(gaps([(o.start, o.end) for o in self.device], self.lo, self.hi),
                    key=lambda g: g[0] - g[1])
        starts = np.array([o.start for o in self.host], dtype=np.int64)
        ends = np.array([o.end for o in self.host], dtype=np.int64)
        short = "(shorter gaps)"
        if len(gs) > labelled:
            s, e = gs[labelled - 1]
            short = f"(gaps under {(e - s) / 1e3:.1f} us)"
        by = {}
        for i, (s, e) in enumerate(gs):
            label = short
            if i < labelled:
                label = "(no host event)"
                mid = (s + e) // 2
                j = int(np.searchsorted(starts, mid, side="right"))
                hit = np.nonzero(ends[max(0, j - 4000): j] >= mid)[0]
                if hit.size:
                    label = self.host[max(0, j - 4000) + int(hit[-1])].name
            by[label] = by.get(label, 0) + e - s
        return [[name[:160], ns * 1e-9] for name, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _kind(ev) -> str:
    """The event's activity kind, from the profiler where it says so, else
    from its device and name (a device event that is neither a copy, a set
    nor an annotation or a synchronisation is a kernel)."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    name = ev.name()
    if "CUDA" not in str(ev.device_type()):
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if name == WINDOW or "Synchronize" in name or "Wait" in name:
        return "gpu_other"
    return "kernel"


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``, bounded by its
    "window" span on the host."""
    ops = []
    for ev in prof.profiler.kineto_results.events():
        s = int(ev.start_ns())
        ops.append(Op(_kind(ev), ev.name(), s, s + int(ev.duration_ns())))
    win = [o for o in ops if o.name == WINDOW and o.kind in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window span")
    return Trace(ops, win[0].start, win[0].end)
