"""plan_miss_pct (%, program counter): the frame plans' misses and retries
over the window, per dense-route frame the program counted:
100 * delta(density_miss + grid_miss + caps_retry + overflow_retry) /
delta(frames) of ``splashsurf_tpu_torch.global_pipeline.SPECULATION_STATS``.
A grid miss runs the frame again, and the program counts that run as a
frame too."""

MISSES = ("density_miss", "grid_miss", "caps_retry", "overflow_retry")


def _stats():
    from splashsurf_tpu_torch.global_pipeline import SPECULATION_STATS

    return dict(SPECULATION_STATS)


def before_window(run):
    run.state["plan_stats_0"] = _stats()


def after_window(run):
    before, after = run.state["plan_stats_0"], _stats()
    run.state["plan_stats"] = {k: after[k] - before[k] for k in after}


def read(run):
    d = run.state["plan_stats"]
    if d["frames"] <= 0:
        return None
    return 100.0 * sum(d[k] for k in MISSES) / d["frames"]
