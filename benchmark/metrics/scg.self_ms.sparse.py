"""scg.self_ms.sparse: per SCG iteration of the traced segment, the time of
the program's `gpc.scg.iter` span less that of the `gpc.eval.*` spans
inside it (the objective's forward, backward and fetch), in ms: SCG's
float64 host step, with the harness's record of each evaluation between
the two.  None where the program has no such span."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run.trace, "gpc.scg.iter", "gpc.eval.")
