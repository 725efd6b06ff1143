"""device_idle_pct (%, device trace): 100 * (1 - the union of the device's
kernel, copy and set intervals in the traced window / the window's wall
time)."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
