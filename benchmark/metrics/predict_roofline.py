"""predict_roofline: for the requests of the traced part, the least time of
each for its actual rows (the larger of its bytes over HBM's rate and its
operations, harness.flops.request, over the peak of the precision the
configuration states for serving) summed, over the device time inside
their predict calls (the union of the device's operations within each
call's span), in %."""

from harness import flops, peaks


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    calls = t.spans_named("predict")
    cfg = run.config
    peak = peaks.PEAK[cfg["precision"]["serving"]]
    least = dev = 0.0
    for (a, b), (_, _, _, rows) in zip(calls, run.requests):
        least += max(flops.request_bytes(cfg, rows) / peaks.HBM_BPS,
                     flops.request(cfg, rows) / peak)
        dev += t.busy_in(a, b) / 1e6
    return 100.0 * least / dev if dev > 0 else None
