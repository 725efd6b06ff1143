"""Terminal progress reporting for file-sequence runs (a copy of
``splashsurf_tpu.progress``).

Dependency-free analog of the reference's indicatif integration: a global
"current progress bar" that log output suspends around so records never tear
the bar line (splashsurf/src/logging.rs:13-75), driven by the sequence loop
(splashsurf/src/reconstruct.rs:394-440: per-file ``inc``, ``finish`` at the
end, style ``[elapsed] [=bar>] pos/len (pct%) - remaining: [eta]``).

The bar only renders when the target stream is a TTY; headless runs (tests,
driver invocations, redirected output) pay nothing.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Optional

__all__ = [
    "ProgressBar",
    "get_progress_bar",
    "set_progress_bar",
    "ProgressAwareStreamHandler",
]

_CURRENT: Optional["ProgressBar"] = None
_CURRENT_LOCK = threading.Lock()


def get_progress_bar() -> Optional["ProgressBar"]:
    return _CURRENT


def set_progress_bar(pb: Optional["ProgressBar"]) -> None:
    global _CURRENT
    with _CURRENT_LOCK:
        _CURRENT = pb


def _fmt_hms(seconds: float) -> str:
    if seconds != seconds or seconds == float("inf"):  # NaN / unknown
        return "--:--:--"
    s = int(seconds)
    return f"{s // 3600:02d}:{(s // 60) % 60:02d}:{s % 60:02d}"


class ProgressBar:
    """Thread-safe terminal progress bar (mt-files increments from workers)."""

    def __init__(self, total: int, stream=None, width: int = 40):
        self.total = max(int(total), 1)
        self.n = 0
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = bool(getattr(self.stream, "isatty", lambda: False)())
        self._t0 = time.perf_counter()
        self._lock = threading.RLock()
        self._draw()

    def _render(self) -> str:
        frac = min(self.n / self.total, 1.0)
        filled = int(frac * self.width)
        if filled >= self.width:
            bar = "=" * self.width
        else:
            bar = "=" * filled + ">" + " " * (self.width - filled - 1)
        elapsed = time.perf_counter() - self._t0
        eta = elapsed * (self.total - self.n) / self.n if self.n else float("inf")
        return (
            f"[{_fmt_hms(elapsed)}] [{bar}] {self.n}/{self.total} "
            f"({100 * frac:.0f}%) - remaining: [{_fmt_hms(eta)}]"
        )

    def _draw(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.stream.write("\r" + self._render() + "\x1b[K")
            self.stream.flush()

    def _clear(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.stream.write("\r\x1b[K")
            self.stream.flush()

    def inc(self, k: int = 1) -> None:
        with self._lock:
            self.n += k
        self._draw()

    def finish(self) -> None:
        with self._lock:
            self.n = self.total
        if self.enabled:
            with self._lock:
                self.stream.write("\r" + self._render() + "\x1b[K\n")
                self.stream.flush()

    def suspend(self, fn):
        """Run ``fn`` with the bar cleared, then redraw (logging.rs:23-30)."""
        with self._lock:
            self._clear()
            try:
                return fn()
            finally:
                self._draw()


class ProgressAwareStreamHandler(logging.StreamHandler):
    """StreamHandler that suspends the active progress bar around each record
    so log lines and the bar never interleave (ProgressHandler::write,
    logging.rs:44-56)."""

    def emit(self, record):
        pb = get_progress_bar()
        if pb is not None:
            pb.suspend(lambda: super(ProgressAwareStreamHandler, self).emit(record))
        else:
            super().emit(record)
