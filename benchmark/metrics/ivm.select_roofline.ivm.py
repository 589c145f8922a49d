"""ivm.select_roofline.ivm: the least time of the traced segment's
selection passes (harness.ivm_work.pass_least_s, the model's bytes over
HBM's rate or its float32 FLOPs over the peak, the larger, a pass) over
the device's busy time inside their `gpc.ivm.select` spans, in %.  None
where the program opens no such span."""

from harness import ivm_work, named_spans


def read(run):
    busy = named_spans.busy_s(run.trace, "gpc.ivm.select")
    if not busy:
        return None
    passes = len(named_spans.inside(run.trace, "gpc.ivm.select"))
    return 100.0 * passes * ivm_work.pass_least_s(run.config) / busy
