"""device.idle.train: the share of the traced segment in which no device
operation runs: the union of the operations' intervals over all streams,
never their sum."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
