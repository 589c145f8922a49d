"""device.idle_in_call.serve: the share of the time inside the traced part's
predict calls in which no device operation runs (the union of intervals
over all streams).  Not the whole window: at a fixed rate a faster server
idles more."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    calls = t.spans_named("predict")
    inside = sum(b - a for a, b in calls)
    if inside <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_in(a, b) for a, b in calls) / inside)
