"""device.idle_after_read.sparse: the share, in %, of the device's idle
time inside the traced segment's `objective` spans that lies in gaps
opening where the copy of one of the program's blocking host reads (a
`gpc.host_read` span) ends; the rest is the host's launch rate and its own
work.  None where the program has no such span."""

from harness import program_spans


def read(run):
    return program_spans.idle_after_read(run.trace)
