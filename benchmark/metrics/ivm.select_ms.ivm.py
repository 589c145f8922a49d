"""ivm.select_ms.ivm: the mean wall of one IVM selection pass, ms: the
program's `gpc.ivm.select` spans in the traced segment, each closed by the
pass's blocking read of its order, so the pass's device work lies inside
it.  None where the program opens no such span."""

from harness import named_spans


def read(run):
    return named_spans.mean_ms(run.trace, "gpc.ivm.select")
