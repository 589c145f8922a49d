"""ivm.kernels_per_step.ivm: the device operations that start inside the
traced segment's `gpc.ivm.select` spans over the selection steps the
program counted (`ivm.steps`) between the traced part's open and close.
None where the program opens no such span or counts no step."""

from harness import named_spans


def read(run):
    ops = named_spans.ops_inside(run.trace, "gpc.ivm.select")
    c = getattr(run, "counts", None)
    if ops is None or not c or not c[0] or not c[1]:
        return None
    steps = c[1].get("ivm.steps", 0) - c[0].get("ivm.steps", 0)
    return ops / steps if steps > 0 else None
