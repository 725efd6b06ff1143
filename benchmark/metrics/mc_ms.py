"""mc_ms (ms, program span): the device time of the dense route's "dense
mc" spans (marching cubes, and the mesh streams cut to the pull's
buckets), per frame the window completed (``harness.spans``)."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    return spans.per_frame_ms(run, spans.MC)
