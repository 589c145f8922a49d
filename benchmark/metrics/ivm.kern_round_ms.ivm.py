"""ivm.kern_round_ms.ivm: the mean wall of one SCG round over the kernel
parameters, ms: the program's `gpc.ivm.kern_round` spans in the traced
segment (the active-set objective's evaluations and SCG's host step; the
pass before it is outside).  None where the program opens no such span."""

from harness import named_spans


def read(run):
    return named_spans.mean_ms(run.trace, "gpc.ivm.kern_round")
