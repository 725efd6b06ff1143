#!/usr/bin/env python3
"""Does a ``torch.profiler`` trace hold every kernel of a replayed CUDA graph?

    python3 tools/graph_trace_records.py [--replays 40] [--dot PATH]

On one card: the 2M dam break's warm frame as the mono frame's CUDA graph
(``SPLASHSURF_TPU_MONO_FRAME=1``, ``_PREWARM=1``), captured in debug mode so
that the graph itself can be read: its kernel nodes by name, from
``CUDAGraph.debug_dump`` (a DOT file, written to ``--dot``, by default
``mono_frame_graph.dot`` in the working directory), beside the launches its capture
queued through the port's wrappers (``frame_graph.kernels``). Then
``--replays`` warm frames, each one replay of that graph under its own
``torch.profiler`` trace: each trace's records of K1, K2 and their
pre-passes and of all kernels. Prints one JSON object last: the graph's
kernel nodes, and per trace the records found, with the traces that lack
one of the graph's kernels counted.
"""

import argparse
import collections
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def kernel_nodes(dot: str) -> list:
    """The kernel nodes of a graph's DOT dump (``cudaGraphDebugDotPrint``),
    each as the text of its statement: a node's record label spans lines and
    names its kernel (mangled) on the line of its ID."""
    return [st for st in dot.split('"];') if 'label="{KERNEL' in st]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replays", type=int, default=40)
    ap.add_argument("--dot", default="mono_frame_graph.dot", help="where to dump the graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_trace_records: no CUDA device", file=sys.stderr)
        return 2
    import splashsurf_tpu_torch as pt
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch import frame_graph as FG
    from splashsurf_tpu_torch.ops import splat_kernels as sk

    ident = cs.card_identity()
    sk.load_kernels()
    params = pt.Parameters.new_relative(bench.RADIUS, 4.0, 1.5)
    pts = torch.as_tensor(bench.make_dam_break(2_000_000, bench.RADIUS), device="cuda")
    frames = [pts + k * 1e-6 for k in range(3)]

    make_graph = torch.cuda.CUDAGraph

    def debug_graph(*a, **kw):
        # keep the graph after its instantiation, so that it can be dumped
        try:
            g = make_graph(*a, keep_graph=True, **kw)
        except TypeError:
            g = make_graph(*a, **kw)
        g.enable_debug_mode()
        return g

    torch.cuda.CUDAGraph = debug_graph
    try:
        with cs.switches(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PREWARM="1",
                         SPLASHSURF_TPU_PULL="packed"):
            cs.clear_plans()
            pt.reconstruct_surface(frames[0], params)  # plans, and captures the graph
            torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph = make_graph
    if FG.live() != 1:
        raise AssertionError(f"{FG.live()} live graphs after the planning frame")
    graph = next(iter(FG._GRAPHS.values()))
    dot = os.path.abspath(args.dot)
    os.makedirs(os.path.dirname(dot), exist_ok=True)
    graph.graph.debug_dump(dot)
    if not os.path.exists(dot):
        raise AssertionError(f"debug_dump wrote no {dot}")
    with open(dot) as f:
        text = f.read()
    nodes = kernel_nodes(text)
    by_name = {k: sum(name in node for node in nodes) for k, name in cs.TRACED.items()}

    replays0 = FG.STATS["replays"]
    traces = []
    with cs.switches(SPLASHSURF_TPU_MONO_FRAME="1", SPLASHSURF_TPU_PREWARM="1",
                     SPLASHSURF_TPU_PULL="packed"):
        for r in range(args.replays):
            f = frames[1 + r % 2]
            _, kernels = cs.kernel_trace(lambda: pt.reconstruct_surface(f, params))
            rec = cs.traced_launches(kernels)
            rec["all"] = len(kernels)
            traces.append(rec)
    if FG.STATS["replays"] - replays0 != args.replays:
        raise AssertionError("not every traced frame was one replay of the graph")
    want = {k: by_name[k] for k in cs.TRACED}
    short = [i for i, t in enumerate(traces) if any(t[k] < want[k] for k in want)]
    summary = {
        "card": ident,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "graph_kernel_nodes": len(nodes),
        "graph_nodes_by_kernel": by_name,
        "captured_by_wrappers": FG.kernels(pts.device),
        "replays_traced": args.replays,
        "records_all_min_max": [min(t["all"] for t in traces), max(t["all"] for t in traces)],
        "records_by_kernel": {k: dict(collections.Counter(t[k] for t in traces))
                              for k in cs.TRACED},
        "traces_lacking_a_graph_kernel": len(short),
        "which": short,
        "dot_bytes": len(text),
        "dot_kernel_label_sample": [re.sub(r"\s+", " ", st)[:300] for st in nodes[:2]],
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
