"""upload_ms (ms, device trace): the device time of the host-to-device
copies in the traced window, per frame completed there."""


def read(run):
    t = run.trace
    if t is None or not run.frame_ids:
        return None
    s = sum(min(o.end, t.hi) - max(o.start, t.lo) for o in t.device
            if o.kind == "gpu_memcpy" and "HtoD" in o.name) * 1e-9
    return 1e3 * s / len(run.frame_ids) if s > 0 else None
