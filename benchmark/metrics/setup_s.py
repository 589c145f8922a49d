"""setup_s: seconds from the process's start to the window's: imports, the
kernels' build on a checkout's first run, the data, the model or server
and the warm-up of this cell's shapes (host clock)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
