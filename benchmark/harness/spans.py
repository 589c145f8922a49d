"""The harness's spans around its calls into the program's layers, and the
profiler that traces one fixed part of a window.

A span is a `torch.profiler.record_function` range, so in a traced run it
lands in the profiler's trace on the same clock as the device's
operations; the part of the window that is traced is the one `window`
span.  With tracing off a span is a no-op: the end-to-end metrics are
taken with tracing off."""

from __future__ import annotations

import contextlib

import torch

from harness import trace


class Tracer:
    """Spans and one profiled part of the window, or nothing when off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._window = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """Start and stop the profiler once in set-up, so that the traced
        part does not pay its first start (CUPTI's initialisation)."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum().item()

    def start(self):
        """Open the traced part: start the profiler and the `window` span."""
        if not self.enabled or self.prof is not None:
            return
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self._window = torch.profiler.record_function("window")
        self._window.__enter__()

    def stop(self):
        """Close the traced part (after the device has finished its work)."""
        if self._window is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._window = None
        self.prof.stop()

    def read(self):
        """The traced part as a harness.trace.Trace (None when off)."""
        return None if self.prof is None else trace.from_profiler(self.prof)
