"""Reading a torch.profiler trace: device operations, busy time, idle gaps.

The device-time arithmetic is a copy of gpc_tpu_torch/profile_slice.py's
`trace_kernels`: a kernel launched early by programmatic dependent launch
(K3's) starts while the one before it on its stream runs and waits for it,
so each operation's time starts where the one before it on its stream
ended, and the operations of one stream never overlap.  Summed over
several streams they may exceed the wall; the busy time is therefore the
measure of the union of the operations' intervals over all streams, never
their sum."""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"


def clip_streams(events: list[dict]) -> list[tuple[str, object, float, float]]:
    """[(name, stream, start µs, end µs)] of device events, each clipped to
    start no earlier than the end of the one before it on its stream."""
    out, stream_end = [], {}
    for e in sorted(events, key=lambda e: e["ts"]):
        stream = e.get("args", {}).get("stream")
        end = e["ts"] + e["dur"]
        start = max(e["ts"], stream_end.get(stream, e["ts"]))
        stream_end[stream] = max(end, stream_end.get(stream, end))
        out.append((e["name"], stream, start, max(start, end)))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    merged = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def measure(merged, lo: float, hi: float) -> float:
    """Length of the part of disjoint intervals `merged` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that disjoint intervals `merged` leave free."""
    out, t = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


@dataclass
class Trace:
    """One traced part of a window, in the trace's µs.  `lo`, `hi` bound
    the part (the harness's `window` span); `ops` are the clipped device
    operations; `spans` the harness's host spans (name, start, end)."""

    lo: float
    hi: float
    ops: list
    spans: list
    file_bytes: int = 0
    busy: list = field(init=False)

    def __post_init__(self):
        self.busy = union((a, b) for _, _, a, b in self.ops)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return measure(self.busy, self.lo, self.hi) / 1e6

    def spans_named(self, name: str) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == name]

    def busy_in(self, lo: float, hi: float) -> float:
        return measure(self.busy, lo, hi)

    def ops_matching(self, pred) -> list[tuple[float, float]]:
        return union((a, b) for name, _, a, b in self.ops if pred(name))

    def device_ops(self, top: int = 10) -> list[list]:
        """[[name, seconds]] of the device operations that took most time
        inside the part (each stream's operations clipped as above)."""
        tot = {}
        for name, _, a, b in self.ops:
            t = max(0.0, min(b, self.hi) - max(a, self.lo))
            if t > 0:
                tot[name] = tot.get(name, 0.0) + t / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def host_span_at(self, t: float, outer: str) -> str:
        """The innermost harness span open at trace time t, else `outer`."""
        best = None
        for name, a, b in self.spans:
            if a <= t < b and name != "window" and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else outer

    def idle_gaps(self, outer: str, top: int = 10) -> list[list]:
        """[[label, seconds]]: the device's idle time inside the part,
        summed by the harness span open on the host at each gap's middle,
        the labels with the most idle time first."""
        by = {}
        for a, b in gaps(self.busy, self.lo, self.hi):
            label = self.host_span_at(0.5 * (a + b), outer)
            n, tot, longest = by.get(label, (0, 0.0, 0.0))
            by[label] = (n + 1, tot + (b - a) / 1e6, max(longest, (b - a) / 1e6))
        rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
        return [[f"{label}: {n} gaps, longest {longest!r} s", tot]
                for label, (n, tot, longest) in rows]


def from_events(events: list[dict], file_bytes: int = 0) -> Trace:
    """A Trace from chrome-trace events holding one `window` span."""
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == SPAN_CAT and "dur" in e]
    windows = [(a, b) for n, a, b in spans if n == "window"]
    if len(windows) != 1:
        raise ValueError(f"a trace holds {len(windows)} window spans, want 1")
    lo, hi = windows[0]
    ops = clip_streams([e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e])
    return Trace(lo=lo, hi=hi, ops=ops, spans=spans, file_bytes=file_bytes)


def from_profiler(prof) -> Trace:
    """Export the profiler's chrome trace to a temporary file (TMPDIR),
    read it back and delete it."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return from_events(events, file_bytes=size)
