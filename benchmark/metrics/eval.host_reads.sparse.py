"""eval.host_reads.sparse: the program's blocking device-to-host reads per
evaluation of the objective in the traced segment: its `gpc.host_read`
spans over its `gpc.eval.forward` spans (one of each an evaluation).  A
DTC evaluation reads 3 times a jitchol (its factor's info, the finiteness
of L[-1, -1], its backward's finiteness test) for K_uu and Am, and fetches
the value and the gradient: 8, more where a factor needs jitter.  None
where the program has no such span."""

from harness import program_spans


def read(run):
    return program_spans.per_span(run.trace, program_spans.READ, "gpc.eval.forward")
