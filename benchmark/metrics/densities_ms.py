"""densities_ms (ms, program span): the device time of the program's
"compute particle densities" spans (the densities and the weights m / rho,
redone frames included), per frame the window completed
(``harness.spans``)."""

from harness import spans


def before_window(run):
    spans.before_window(run)


def after_window(run):
    spans.after_window(run)


def read(run):
    return spans.per_frame_ms(run, spans.DENSITIES)
