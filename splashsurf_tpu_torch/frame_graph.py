"""The single-dispatch warm frame on the card: one CUDA graph per plan set.

The reference runs a warm dense frame on its plans as one ``jax.jit``
program, one dispatch and one read back (``global_pipeline._warm_frame``
of the reference, switched on by ``SPLASHSURF_TPU_MONO_FRAME``). The
port's counterpart of one dispatch is the replay of a CUDA graph that holds
every launch of the frame (``global_pipeline._try_warm_frame``).

``run(slot, key, fn, positions)`` gives ``fn(positions)``. The first frame
of a key runs ``fn`` eagerly on a side stream: that run fills the device
constants that ``fn`` caches, sets the kernels' shared memory attributes
and is the frame's result. Then ``fn`` is captured once more into a graph
with its own memory pool, on an input tensor of the graph's own. Every
later frame of the key copies its positions into that input and replays
the graph; its outputs are the graph's static tensors, which the next
replay overwrites, so the caller copies what it keeps before the next
frame. Capture and replay never fall back: an operation that cannot be
captured (one that reads the card, or copies from pageable host memory)
raises, naming the line that made it.

At most one graph lives per card. Each graph holds its own memory pool
(593,494,016 B for a 2M-particle frame, ``chip_smoke.py`` phase 20 on an
NVIDIA H100 80GB HBM3 at 700 W), and a new grid origin is a new ``slot``
(the frame's grid, N, dtype and device): a sequence of numpy frames, whose
grid follows the fluid, would otherwise keep one pool per origin, where the
reference keeps compiled programs that hold no buffers. So before a capture
``run`` drops every graph of the positions' card, whatever its slot, and
does so before the eager run: nothing then holds the old graph's input or
outputs when the capture begins, and the capture's entry (a synchronise
and an emptied allocator cache) returns the old pool to the card. The slot
and the key still decide whether a frame replays; frames that alternate
between two plan sets capture each time. ``drop(slot)`` drops the slot's
graph (a plan that missed), ``drop()`` every graph (the plans cleared).
The caller keeps no tensor of a graph past the next frame
(``global_pipeline`` clones rho and copies the packed buffer to the host),
so nothing pins a dropped pool.

The kernel wrappers count the launches that run eagerly in
``<wrapper>.launches``, and a launch queued during a capture apart, in
``<wrapper>.captured`` (``ops.splat_kernels._count``); a replay counts
nothing. Each graph records the launches of each kernel that its capture
queued (``kernels()``): every replay runs each of them once.
"""

from __future__ import annotations

import functools
import time
import traceback

import torch

from splashsurf_tpu_torch.ops import splat_kernels

# slot -> _FrameGraph; at most one per card
_GRAPHS: dict = {}
# captures and replays since the process started, and the host seconds of
# the last capture (read by chip_smoke.py, never by the pipeline)
STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}


@functools.cache
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for the eager run before a capture."""
    return torch.cuda.Stream(device=device)


class _FrameGraph:
    """A captured frame: its key, its input, its static outputs and the
    graph."""

    def __init__(self, key):
        self.key = key
        self.graph = self.input = self.out = None
        # wrapper name -> launches of its kernel that the capture queued
        self.kernels = {}

    def capture(self, fn, positions: torch.Tensor):
        dev = positions.device
        cur = torch.cuda.current_stream(dev)
        side = _warmup_stream(dev)
        side.wait_stream(cur)
        positions.record_stream(side)
        with torch.cuda.stream(side):
            out = fn(positions)
        cur.wait_stream(side)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        self.input = torch.empty_like(positions)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        before = splat_kernels.captured_counts()
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn(self.input)
        except Exception as e:
            tb = traceback.extract_tb(e.__traceback__)
            ours = [f for f in tb if "splashsurf_tpu_torch" in f.filename]
            where = (ours or tb)[-1]  # the port's line that made the failing call
            raise RuntimeError(
                f"the warm frame cannot be captured as a CUDA graph: {where.filename}:"
                f"{where.lineno} `{where.line}` raised {type(e).__name__}: {e}"
            ) from e
        STATS["captures"] += 1
        STATS["capture_s"] = time.perf_counter() - t0
        after = splat_kernels.captured_counts()
        self.kernels = {name: n - before[name] for name, n in after.items() if n != before[name]}
        return out

    def replay(self, positions: torch.Tensor):
        self.input.copy_(positions)
        self.graph.replay()
        STATS["replays"] += 1
        return self.out


def run(slot, key, fn, positions: torch.Tensor):
    """``fn(positions)`` for CUDA ``positions``: the replay of the slot's
    graph where it was captured for ``key``, else, once every graph of the
    card is dropped, an eager run followed by the capture of the slot's new
    graph (see the module's docstring)."""
    g = _GRAPHS.get(slot)
    if g is not None and g.key == key:
        return g.replay(positions)
    for other in [s for s, o in _GRAPHS.items() if o.input.device == positions.device]:
        del _GRAPHS[other]
    g = _FrameGraph(key)
    out = g.capture(fn, positions)
    _GRAPHS[slot] = g
    return out


def drop(slot=None) -> None:
    """Drop the graph of ``slot``, or every graph."""
    if slot is None:
        _GRAPHS.clear()
    else:
        _GRAPHS.pop(slot, None)


def live() -> int:
    """The graphs that are live."""
    return len(_GRAPHS)


def kernels(device=None) -> dict:
    """The kernel launches that the live graph of ``device`` (default: the
    only live graph) queued when it was captured, by wrapper name: each of
    its replays runs each of them once."""
    graphs = [g for g in _GRAPHS.values() if device is None or g.input.device == device]
    if len(graphs) != 1:
        raise ValueError(f"{len(graphs)} live graphs on {device}")
    return dict(graphs[0].kernels)


def pool_bytes() -> int:
    """The device bytes that the live graphs' memory pools hold (segments
    of the caching allocator's snapshot)."""
    pools = {tuple(g.graph.pool()) for g in _GRAPHS.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)
