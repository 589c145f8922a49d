"""Traffic kind `open_loop`: prediction requests on a fixed schedule.

Arrivals are a Poisson process at the mix's `rate` (requests a second),
each request `rows` test inputs drawn log-uniformly on [rows_min,
rows_max]: the quantiles (i + ½)/n of the two distributions, n = rate ×
seconds, in the order that the mix's `schedule_seed` draws.  The order is
the mix's and not the run's: at the load a serving cell runs at, the order
of a heavy-tailed mix moves its latency tail by a quarter between orders,
so every run gets the same schedule, and the run's seed draws the data,
the requests' inputs (slices of a pool of N(0, 1) rows, float64 as a
client sends them) and the sample of answers checked.

One loop serves the requests in arrival order: it waits until a request is
due (span `serve.wait`) unless the server is behind, then calls
`GPServer.predict` (span `predict`).  A request's latency runs from its due
time to predict's return, so time spent queued behind earlier requests
counts.  Requests due in the window are all served; one not started a
minute past the close counts as failed.  Set-up builds the model and the
server (its factor) and runs one predict at each bucket of the server's
padding.  A traced run profiles the requests due in the first
`trace_seconds` of the window.

Correct: `sample` served requests drawn from the seed, with the longest,
are answered again by the float64 reference (reference/<name>.posterior);
mean_gap and var_gap are the largest |got − ref| over the largest |ref| of
all the answers checked: one scale for all, since a one-row answer near
zero would read its rounding as a large share of itself."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import data, judge
from harness.spans import Tracer

LATE_S = 60.0       # how long past the close a request may still start
LEAD_S = 0.01       # the schedule starts this long after set-up ends


def buckets(chunk: int) -> list[int]:
    """The server's padded batch sizes: powers of two up to `chunk`."""
    out, b = [], 1
    while b < chunk:
        out.append(b)
        b <<= 1
    return out + [chunk]


def schedule(seed: int, tr: dict, seconds: float, rate: float | None = None):
    """(due offsets s, rows, pool offsets) of the requests due in a window of
    `seconds`: the quantiles of the mix's distributions in the order of its
    schedule_seed; the pool offsets from the run's seed."""
    rate = float(tr["rate"] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    lo, hi = math.log(tr["rows_min"]), math.log(tr["rows_max"] + 1)
    rows = np.clip(np.floor(np.exp(lo + u * (hi - lo))), tr["rows_min"], tr["rows_max"])
    gaps = -np.log1p(-u)
    gaps *= seconds / gaps.sum()
    g = data.rng(int(tr["schedule_seed"]), data.TRAFFIC)
    rows = rows[g.permutation(n)].astype(np.int64)
    gaps = gaps[g.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    offsets = data.rng(seed, data.TRAFFIC).integers(0, tr["pool_rows"] - rows + 1)
    return due, rows, offsets


def prepare(cell, seed: int, device: str, trace: bool):
    """Set-up: the data, the model, the server and its warm buckets, and
    the pool of test inputs."""
    cfg, tr = cell.config, cell.traffic
    system = cell.system()
    system.configure(cfg)
    X, y = data.regression(seed, cfg["N"], cfg["q"], cfg["D"], cfg["noise"])
    gp = system.model(cfg, X, y, seed, device)
    server = system.server(cfg, gp)
    pool = data.rng(seed, data.INPUTS).standard_normal((int(tr["pool_rows"]), cfg["q"]))
    for b in buckets(int(cfg["chunk"])):
        server.predict(pool[:b])
    tracer = Tracer(trace)
    tracer.warm()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return dict(X=X, y=y, gp=gp, server=server, pool=pool, tracer=tracer,
                theta=gp.theta.copy())


def serve(state, due, rows, offsets, keep=(), trace_until: float = -1.0):
    """Serve the schedule.  Returns ([(due, start, end, rows)] in host
    seconds, {index: (mu, var)} of the requests in `keep`, requests not
    started by the close plus LATE_S)."""
    server, pool, tracer = state["server"], state["pool"], state["tracer"]
    keep, answers, out = set(keep), {}, []
    t0 = time.perf_counter() + LEAD_S
    close = t0 + (due[-1] if len(due) else 0.0)
    tracing = trace_until > 0
    if tracing:
        tracer.start()
    for i, (d, r, o) in enumerate(zip(due, rows, offsets)):
        t_due = t0 + d
        if tracing and d >= trace_until:
            tracer.stop()
            tracing = False
        now = time.perf_counter()
        if now > close + LATE_S:
            return out, answers, len(due) - i
        if now < t_due:
            with tracer.span("serve.wait"):
                while (left := t_due - time.perf_counter()) > 0:
                    if left > 5e-4:
                        time.sleep(left - 3e-4)
        Xi = pool[o:o + r]
        with tracer.span("predict"):
            start = time.perf_counter()
            mu, var = server.predict(Xi)
            end = time.perf_counter()
        out.append((t_due, start, end, int(r)))
        if i in keep:
            answers[i] = (mu, var)
    if tracing:
        tracer.stop()
    return out, answers, 0


def sample_of(seed: int, rows: np.ndarray, k: int) -> list[int]:
    """`k` requests drawn from the seed, and the longest."""
    g = data.rng(seed, data.SAMPLE)
    drawn = g.choice(rows.size, size=min(k, rows.size), replace=False).tolist()
    return sorted(set(drawn) | {int(np.argmax(rows))})


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_proc: float,
        run_record) -> judge.Outcome:
    tr = cell.traffic
    state = prepare(cell, seed, device, trace)
    run = run_record
    run.setup_s = time.perf_counter() - t_proc
    due, rows, offsets = schedule(seed, tr, seconds)
    keep = sample_of(seed, rows, int(tr["sample"]))
    t_start = time.perf_counter()
    out, answers, unserved = serve(state, due, rows, offsets, keep,
                                   trace_until=float(tr["trace_seconds"]) if trace else -1.0)
    run.window_s = time.perf_counter() - t_start
    run.requests = out
    if torch.device(device).type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.trace = state["tracer"].read()
    checks = check(cell, state, rows, offsets, answers, keep, device)
    return judge.Outcome(run=run, attempted=len(due), failed=unserved, checks=checks)


def check(cell, state, rows, offsets, answers, keep, device) -> dict:
    """mean_gap and var_gap of the kept answers against the reference, after
    the program's model and server are freed."""
    cfg = cell.config
    X, y, theta, pool = state["X"], state["y"], state["theta"], state["pool"]
    for k in ("server", "gp"):
        state.pop(k, None)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference()
    st = ref.posterior_state(cfg, X, y, theta, device=device)
    refs = {i: ref.posterior(st, pool[offsets[i]:offsets[i] + rows[i]]) for i in keep}
    mu_scale = max(float(np.abs(m).max()) for m, _ in refs.values())
    var_scale = max(float(np.abs(v).max()) for _, v in refs.values())
    mean_gap = var_gap = 0.0
    for i, (mu_ref, var_ref) in refs.items():
        mu, var = answers.get(i, (None, None))
        mean_gap = max(mean_gap, judge.answer_gap(mu, mu_ref, mu_scale))
        var_gap = max(var_gap, judge.answer_gap(var, var_ref, var_scale))
    return dict(mean_gap=mean_gap, var_gap=var_gap)
