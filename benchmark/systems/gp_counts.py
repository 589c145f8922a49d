"""The program's own counters for the metric readers: the snapshot
`gpc_tpu_torch.utils.profiling.counts()` takes of its `COUNTS` (GPServer's
rows and padded rows, each blocking host read by site).  The counters are
always on and count from the process's start, so a reader reads them over
the run: set-up and window.  A program without them gives None."""

from __future__ import annotations


def counts() -> dict | None:
    """The program's counters, or None where it keeps none."""
    from gpc_tpu_torch.utils import profiling

    read = getattr(profiling, "counts", None)
    return None if read is None else read()
