"""throughput (Mparticles/s, host clock): the particles of every frame the
window completed, over the window's seconds from its start to the last
frame's end."""

from harness.stats import rate


def read(run):
    if not run.frame_ids:
        return None
    return rate(sum(run.n[k] for k in run.frame_ids), run.window_s) / 1e6
