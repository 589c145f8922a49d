"""ivm.select_idle.ivm: the share, in %, of the time inside the traced
segment's `gpc.ivm.select` spans in which no device operation runs (the
union of the operations' intervals over all streams): the host's launches
and the graph's gaps between its kernels.  None where the program opens no
such span."""

from harness import named_spans


def read(run):
    return named_spans.idle_share(run.trace, "gpc.ivm.select")
