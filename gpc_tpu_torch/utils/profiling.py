"""Tracing and timing helpers (counterpart of gpc_tpu/utils/profiling.py).

The reference has no profiling beyond verbosity-gated output; gpc_tpu adds
a profiler trace, per-call timing with a reliable synchronisation and the
FLOP count of the FTC evidence, and so does the port:

  * `trace(log_dir)`: a torch.profiler trace (CPU, and CUDA when there is a
    card) written to log_dir for TensorBoard or chrome://tracing;
  * `time_fn`: mean seconds a call.  On the card it times with CUDA events
    around the calls.  Off the card it keeps gpc_tpu's method: host clock
    around the calls and one fetch of the first output, less that fetch's
    own cost (`measure_rtt`).  gpc_tpu subtracts the round trip to a remote
    TPU; here the fetch is local and the correction small.

The port adds spans and counters at its layer boundaries:

  * `span(name)`: a `torch.profiler.record_function` range while a torch
    profiler records (`trace`, or any other `torch.profiler.profile`), so
    it lands in the trace on the clock of the device's operations; with no
    profiler recording, one shared no-op context that never calls into the
    profiler.  Every span of the program is named `gpc.<layer>.<step>`:

      gpc.scg.iter, gpc.scg.probe, gpc.scg.trial     optim/scg.py
      gpc.eval.forward, gpc.eval.backward,
      gpc.eval.fetch                                 optim.numpy_value_and_grad
      gpc.linalg.chol, gpc.linalg.chol_bwd and
      gpc.linalg.evidence_bwd (on autograd's device
      thread on the card), gpc.linalg.jitter         linalg.py
      gpc.host_read                                  each blocking device-to-host read
      gpc.serve.stage, gpc.serve.apply,
      gpc.serve.fetch                                serving.GPServer.predict

  * `COUNTS`: counters, always on, and `counts()`, a snapshot of them:
    `host_read.<site>` (one a read, beside its `gpc.host_read` span; each
    stage of profile_slice prints them by site), `evidence.inverse_vjp`
    (dense evidence backwards that formed K⁻¹; profile_slice prints it a
    stage), `serve.rows` (rows asked for) and `serve.pad_rows` (rows the
    power-of-two buckets add; the benchmark's `serve.pad_share.serve`
    reads the two).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

# the program's counters (module docstring); `counts()` reads them
COUNTS: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a torch profiler
    records, else one shared no-op context: off, a span costs one flag
    read (a `record_function` with no profiler costs microseconds)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def host_read(site: str):
    """Count one blocking device-to-host read at `site` under
    `host_read.<site>` and return the `gpc.host_read` span to hold it."""
    COUNTS["host_read." + site] += 1
    return span("gpc.host_read")


def counts() -> dict:
    """A snapshot of `COUNTS`."""
    return dict(COUNTS)


def _first_tensor(x):
    """The first tensor in x (a tensor, or nested tuples, lists and dicts),
    None if there is none."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync(x):
    """Wait for the first tensor of x and return its first element as a
    float (a value fetch waits for the device)."""
    return float(_first_tensor(x).reshape(-1)[0])


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written to log_dir when it ends;
    yields the profiler.  The program's `gpc.*` spans are in it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def measure_rtt(samples: int = 8, device=None) -> float:
    """Least seconds, over `samples`, of one trivial operation on `device`
    (the card when there is one, unless the caller asks for the CPU) and
    the fetch of its result: the fixed cost of the synchronising fetch that
    `time_fn` subtracts off the card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    one = torch.ones(1, device=device)
    sync(one + 1.0)
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        sync(one + 1.0)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """Mean seconds a call of fn(*args) over `reps` calls, after `warmup`
    untimed calls.  fn returns at least one tensor.  CUDA output: CUDA
    events around the calls.  Otherwise: host clock around the calls and
    one fetch of the first output, less `measure_rtt`."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        sync(out)
    probe = _first_tensor(out if out is not None else args)
    if probe is not None and probe.device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    rtt = measure_rtt(device=probe.device if probe is not None else "cpu")
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    sync(out)
    return max(time.perf_counter() - t0 - rtt, 0.0) / reps


def evidence_flops(n: int, q: int, d: int) -> float:
    """FLOPs of the FTC evidence: Gram (2N²q) + Cholesky (N³/3) + solves
    (2N²D)."""
    return 2.0 * n * n * q + n ** 3 / 3.0 + 2.0 * n * n * d


def step_report(name: str, seconds: float, flops: float | None = None) -> str:
    """gpc_tpu's one-line report of a timed step, with GFLOP/s when the
    FLOPs are given."""
    msg = f"[gpc_tpu] {name}: {seconds * 1e3:.2f} ms"
    if flops:
        msg += f" ({flops / seconds / 1e9:.1f} GFLOP/s)"
    return msg
