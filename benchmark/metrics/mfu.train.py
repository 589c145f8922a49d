"""mfu.train: the model FLOPs of every evaluation in the window
(harness.flops.evaluation, fixed from the configuration's shapes) over the
window times the card's dense bf16 peak, in %."""

from harness import flops, peaks


def read(run):
    n = sum(s[3] for s in run.segments)
    if not n or run.window_s <= 0:
        return None
    return 100.0 * n * flops.evaluation(run.config) / (run.window_s * peaks.MFU_PEAK)
