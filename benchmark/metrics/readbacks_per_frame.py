"""readbacks_per_frame (count, program counter): the program's reads of
the card by the host over the window (the change of
``splashsurf_tpu_torch.profiling.COUNTERS["readbacks"]``), per frame the
window completed (``harness.spans``)."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    n = spans.readbacks(run)
    if n is None or not run.frame_ids:
        return None
    return n / len(run.frame_ids)
