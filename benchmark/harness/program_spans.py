"""The program's own spans in a traced run: the `gpc.*` ranges that
gpc_tpu_torch/utils/profiling.py opens at its layer boundaries while a
profiler records.  They land in the trace beside the harness's spans
(harness/spans.py) on the same clock, and no program span is named as a
harness span, so the readers that match harness spans by name read the
same with or without them.

A harness.trace.Trace holds spans by name and time, without their thread
or the launch of each device operation, so the readings here are a span's
count, its self time less its children's, and the device's idle time after
a host read's copy.  A blocking read waits for its copy to land, so the
copy runs inside the read's `gpc.host_read` span: a device-to-host copy
whose interval lies in such a span is that read's copy, without the launch
that issued it.
"""

from __future__ import annotations

import bisect

from harness import trace

READ = "gpc.host_read"


def per_span(t, name: str, per: str) -> float | None:
    """The spans `name` that open in the traced part over the spans `per`
    that open in it.  None where it holds no span `per`."""
    if t is None:
        return None
    n_per = sum(t.lo <= a < t.hi for a, _ in t.spans_named(per))
    return sum(t.lo <= a < t.hi for a, _ in t.spans_named(name)) / n_per if n_per else None


def self_ms(t, name: str, child_prefix: str) -> float | None:
    """Mean ms of the spans `name` in the traced part less the time of the
    spans whose names start with `child_prefix` inside each (which do not
    overlap: they run one after another on the thread).  None where the
    trace holds no span `name`."""
    if t is None:
        return None
    outer = [(a, b) for a, b in t.spans_named(name) if t.lo <= a and b <= t.hi]
    if not outer:
        return None
    kids = sorted((a, b) for n, a, b in t.spans if n.startswith(child_prefix))
    starts = [a for a, _ in kids]
    total = 0.0
    for a, b in outer:
        i = bisect.bisect_left(starts, a)
        inside = 0.0
        while i < len(kids) and kids[i][0] < b:
            if kids[i][1] <= b:
                inside += kids[i][1] - kids[i][0]
            i += 1
        total += (b - a) - inside
    return total / len(outer) / 1e3


def read_copies(t) -> list[tuple[float, float]]:
    """The (start, end) of each device-to-host copy that runs inside a
    `gpc.host_read` span (the spans of one thread do not overlap)."""
    reads = sorted(t.spans_named(READ))
    starts = [a for a, _ in reads]
    out = []
    for name, _, a, b in t.ops:
        if "DtoH" not in name:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= reads[i][1]:
            out.append((a, b))
    return out


def idle_after_read(t, outer: str = "objective") -> float | None:
    """The share, in %, of the device's idle time inside the harness spans
    `outer` that lies in gaps opening where a host read's copy ends: the
    gaps the reads' round trips leave, the rest being the host's launch
    rate and its own work.  None where the trace holds no device operation,
    no span `outer` or no program read."""
    if t is None or not t.ops or not t.spans_named(READ):
        return None
    inside = trace.union(t.spans_named(outer))
    if not inside:
        return None
    ends = {b for _, b in read_copies(t)}
    idle = after = 0.0
    for a, b in trace.gaps(t.busy, t.lo, t.hi):
        s = trace.measure(inside, a, b)
        idle += s
        if a in ends:
            after += s
    return 100.0 * after / idle if idle > 0 else None
