"""grid_read_pct (%, program counter): the tensor frames that held a grid
plan but read their grid before the frame instead of speculating on it
(the change of ``splashsurf_tpu_torch.plans.GRID_CHECK_STATS["read"]``
over the window), per frame the window completed. A program without the
counter leaves the metric unread."""


def _reads():
    try:
        from splashsurf_tpu_torch import plans
    except ImportError:
        return None
    stats = getattr(plans, "GRID_CHECK_STATS", None)
    return None if stats is None else int(stats["read"])


def before_window(run):
    run.state["grid_reads_0"] = _reads()


def after_window(run):
    before, after = run.state["grid_reads_0"], _reads()
    run.state["grid_reads"] = None if before is None or after is None else after - before


def read(run):
    n = run.state.get("grid_reads")
    if n is None or not run.frame_ids:
        return None
    return 100.0 * n / len(run.frame_ids)
