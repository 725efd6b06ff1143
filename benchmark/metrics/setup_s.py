"""setup_s (s, host clock): from the start of the harness's process to the
window's start: imports, the scene and its frames, their copy to the
host, the kernels' load or build, and the warm-up frames."""


def read(run):
    return run.setup_s
