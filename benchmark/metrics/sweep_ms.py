"""sweep_ms (ms, program span): the device time of the dense route's
"dense raster" and "dense level set" spans (the raster, kernel K1 with its
mask pre-pass, the overflow splat), per frame the window completed
(``harness.spans``)."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    return spans.per_frame_ms(run, spans.SWEEP)
