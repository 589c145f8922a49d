"""train_iter_ms: the window's time over the SCG iterations completed in it
(host clock; the segment in progress at the deadline is finished and
counted, so the window ends with it)."""


def read(run):
    iters = sum(s[2] for s in run.segments)
    return run.window_s / iters * 1e3 if iters else None
