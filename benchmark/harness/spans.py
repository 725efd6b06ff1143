"""The program's own spans and read-back counter over the window, for the
per-layer metrics that read them (``densities_ms``, ``sweep_ms``,
``mc_ms``, ``redo_pct``, ``readbacks_per_frame``, ``upload_fill_ms``).

``before_window`` turns the program's span recorder on, with fresh totals
(``splashsurf_tpu_torch.profiling.record_spans``), and notes its read-back
counter (``profiling.COUNTERS["readbacks"]``). ``after_window``
synchronises the device, reads the span totals and the counter's change,
turns the recorder off, and logs one line per span and the frame's split.
Each runs once per run, whichever metric calls it first. A program without
the recorder or the counter leaves nothing to read, and the metrics read
None."""

from __future__ import annotations

import sys

import torch

KEY = "program_spans"
FRAME = "frame"
REDO = "redo"  # the program's group of the redo spans that no other encloses
DENSITIES = ("compute particle densities",)
SWEEP = ("dense raster", "dense level set")
MC = ("dense mc",)
UPLOAD = ("upload",)


def _profiling():
    from splashsurf_tpu_torch import profiling

    return profiling


def before_window(run) -> None:
    if KEY in run.state:
        return
    prof = _profiling()
    st = run.state[KEY] = {}
    if hasattr(prof, "record_spans") and hasattr(prof, "span_totals"):
        prof.record_spans(True, run.device)
        st["recording"] = True
    counters = getattr(prof, "COUNTERS", None)
    if isinstance(counters, dict) and "readbacks" in counters:
        st["readbacks_0"] = counters["readbacks"]


def after_window(run) -> None:
    st = run.state.get(KEY)
    if st is None or st.get("read"):
        return
    st["read"] = True
    prof = _profiling()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    if st.get("recording"):
        st["totals"] = prof.span_totals()
        prof.record_spans(False)
    if "readbacks_0" in st:
        st["readbacks"] = prof.COUNTERS["readbacks"] - st["readbacks_0"]
    _log(run, st)


def totals(run):
    """The span totals of the window, or None where the program has no
    recorder or the window completed no frame."""
    st = run.state.get(KEY) or {}
    if not run.frame_ids or "totals" not in st:
        return None
    return st["totals"]


def device_ms(run, names) -> float:
    """Device ms of the spans ``names`` over the window (0 where none ran)."""
    t = totals(run) or {}
    return 1e3 * sum(t[n]["device_s"] for n in names if n in t)


def per_frame_ms(run, names):
    """Device ms of the spans ``names`` per completed frame, or None where
    none of them ran."""
    t = totals(run)
    if t is None or not any(n in t for n in names):
        return None
    return device_ms(run, names) / len(run.frame_ids)


def host_per_frame_ms(run, names):
    """Host ms of the spans ``names`` per completed frame, or None where
    none of them ran."""
    t = totals(run)
    if t is None or not any(n in t for n in names):
        return None
    return 1e3 * sum(t[n]["host_s"] for n in names if n in t) / len(run.frame_ids)


def readbacks(run):
    """The read-backs of the window, or None where the program counts none."""
    return (run.state.get(KEY) or {}).get("readbacks")


def _log(run, st) -> None:
    frames = len(run.frame_ids)
    t = st.get("totals")
    if not t or not frames:
        print(f"# spans: nothing recorded (recorder {bool(st.get('recording'))}, "
              f"{frames} frames)", file=sys.stderr)
    else:
        for name, v in sorted(t.items(), key=lambda kv: -kv[1]["device_s"]):
            print(f"# span {name}: {v['count'] / frames:.3f} a frame, host "
                  f"{1e3 * v['host_s'] / frames:.3f} ms, device {1e3 * v['device_s'] / frames:.3f}"
                  f" ms a frame", file=sys.stderr)
        frame = device_ms(run, (FRAME,)) / frames
        stages = {name: device_ms(run, (name,)) / frames for name in DENSITIES + SWEEP + MC}
        covered = sum(stages.values())
        rest = {name: v["device_s"] * 1e3 / frames for name, v in t.items()
                if name not in stages and name != FRAME and not name.startswith(REDO)
                and name != "read back"}
        print(f"# spans: frame {frame:.3f} ms a frame on the device; densities, sweep and mc "
              f"{covered:.3f} ms ({100 * covered / frame if frame else 0:.2f} %); the rest by "
              f"span: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(rest.items()))
              + f"; in no stage span {frame - covered - sum(rest.values()):.3f} ms",
              file=sys.stderr)
        redo = {name: v["device_s"] * 1e3 / frames for name, v in t.items()
                if name.startswith(REDO + " ")}
        print(f"# redo split, ms a frame: " + (", ".join(
            f"{k} {v:.3f} ({t[k]['count']} runs)" for k, v in sorted(redo.items())) or "none")
              + f"; all redo {device_ms(run, (REDO,)) / frames:.3f}", file=sys.stderr)
    if "readbacks" in st:
        print(f"# read-backs: {st['readbacks']} in {frames} frames", file=sys.stderr)
