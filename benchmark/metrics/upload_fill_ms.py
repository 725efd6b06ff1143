"""upload_fill_ms (ms, program span): the host time of the program's
"upload" spans per frame the window completed (``harness.spans``): the
fill of the pinned chunks from the numpy frame and the start of their
copies, during which the card waits. ``upload_ms`` counts the copies'
device time alone."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    return spans.host_per_frame_ms(run, spans.UPLOAD)
