"""Readings of the program's spans by name in a traced run's part: their
mean wall, the device's idle share inside them, and the device operations
that start inside them.  A harness.trace.Trace keeps each span's name and
interval, and each device operation's interval clipped to its stream
(harness/trace.py); every reading here is None where the part holds no
span of the name, as in a program that opens none."""

from __future__ import annotations

import bisect


def inside(t, name: str) -> list[tuple[float, float]]:
    """The spans `name` lying in the traced part, in order (µs)."""
    if t is None:
        return []
    return sorted((a, b) for a, b in t.spans_named(name) if t.lo <= a and b <= t.hi)


def mean_ms(t, name: str) -> float | None:
    s = inside(t, name)
    return sum(b - a for a, b in s) / len(s) / 1e3 if s else None


def busy_s(t, name: str) -> float | None:
    """The device's busy time inside the spans `name`, seconds."""
    s = inside(t, name)
    return sum(t.busy_in(a, b) for a, b in s) / 1e6 if s and t.ops else None


def idle_share(t, name: str) -> float | None:
    """The share, in %, of the time inside the spans `name` in which no
    device operation runs (the union over all streams)."""
    s = inside(t, name)
    wall = sum(b - a for a, b in s)
    if not s or not t.ops or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_in(a, b) for a, b in s) / wall)


def ops_inside(t, name: str) -> int | None:
    """The device operations (kernels, copies, sets) that start inside the
    spans `name`."""
    s = inside(t, name)
    if not s or not t.ops:
        return None
    starts = [a for a, _ in s]
    n = 0
    for _, _, a, _ in t.ops:
        i = bisect.bisect_right(starts, a) - 1
        n += i >= 0 and a < s[i][1]
    return n
