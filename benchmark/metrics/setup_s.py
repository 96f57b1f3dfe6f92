"""setup_s: from the start of the harness to the start of the window:
loading, the images, the build of the kernels on a checkout's first run,
the warm calls (host clock)."""


def read(run):
    return run.setup_s
