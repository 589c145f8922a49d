"""mfu.ivm: the model FLOPs of the window's segments (harness.ivm_work:
each selection pass, kernel-round and noise-round evaluation, fixed from
the configuration's shapes) over the window times the card's dense bf16
peak, in %, as mfu.train.  None in a run whose segments are not an IVM
cell's (each records its passes and its kernel-round and noise-round
evaluations)."""

from harness import ivm_work, peaks


def read(run):
    if not run.segments or run.window_s <= 0 or min(len(s) for s in run.segments) < 7:
        return None
    work = sum(ivm_work.segment_flops(run.config, s[4], s[5], s[6]) for s in run.segments)
    return 100.0 * work / (run.window_s * peaks.MFU_PEAK)
