"""redo_pct (%, program span): the device time of the work that plan
misses made the program repeat, as a share of the frames':
100 * the device seconds of the "redo <plan>" spans that no other redo
span encloses / those of the outermost "frame" spans (``harness.spans``,
which logs the split by plan)."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    t = spans.totals(run)
    frame = spans.device_ms(run, (spans.FRAME,))
    if t is None or frame <= 0:
        return None
    return 100.0 * spans.device_ms(run, (spans.REDO,)) / frame
