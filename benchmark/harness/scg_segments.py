"""Traffic kind `scg_segments`: a closed loop of training segments.

Each segment is what `GP.optimise(iters=...)` runs, `run_optimiser("scg",
model.value_and_grad_fn(), θ₀, iterations)`, and every segment restarts
from the same θ₀ (the CLI defaults), so each does the work of a user's
`gp learn -# <iterations>`.  Segments run back to back until the deadline;
the one in progress when it falls is finished and counted.  Set-up builds
the model from the seed's data and runs one evaluation.  A traced run
profiles the window's first segment.

Correct: the optimiser, the model and the kernels are judged separately.
  step_gap  the reference SCG (reference/scg.py) follows every segment of
            the window step by step from the program's own evaluations;
            the largest departure of a point the program evaluated or
            returned, over the length of the step that led to it.
At the points of the first segment's first three iterations and at
`sample` more points drawn from the seed among the rest of the window, the
float64 reference is evaluated, and each point is judged by the use the
optimiser made of it:
  obj_gap   |f − f_ref| per datum (nats), and
  grad_gap  the worst leaf's gap of gradient norms (judge.leaf_gap), at
            the initial point, the curvature probes and the accepted
            trial steps, whose values and gradients SCG goes on with;
  descent_gap  at a rejected trial step, of which SCG used only the
            decision, how far per datum the reference finds the objective
            below that of the point the step was tried from (0 where the
            reference, too, rejects).  A trial whose objective is not
            finite, SCG's signal of a failed step, is judged so too.
A number is compared where the cell's limits name it."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import data, judge
from harness.spans import Tracer
from harness.spec import module

FIRST_EVALS = 7     # the first three iterations: the initial evaluation and at most two an iteration


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_proc: float,
        run_record) -> judge.Outcome:
    cfg, tr = cell.config, cell.traffic
    system = cell.system()
    system.configure(cfg)
    X, y = data.regression(seed, cfg["N"], cfg["q"], cfg["D"], cfg["noise"])
    gp = system.model(cfg, X, y, seed, device)
    theta0 = gp.theta.copy()
    iters = int(tr["iterations"])
    tracer = Tracer(trace)

    gp.value_and_grad_fn()(theta0)          # warm-up: one evaluation (it ends synchronised)
    tracer.warm()
    run = run_record
    run.setup_s = time.perf_counter() - t_proc

    segments = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        first = not segments
        if first:
            tracer.start()
        evals = []
        vag = _recorded(gp.value_and_grad_fn(), evals, tracer)
        with tracer.span("scg.host"):
            s0 = time.perf_counter()
            res = system.optimise(vag, theta0, iters)
            s1 = time.perf_counter()
        if first:
            tracer.stop()
        segments.append(dict(evals=evals, x=np.asarray(res.x, dtype=np.float64),
                             obj=float(res.obj), iters=int(res.iters)))
        run.segments.append((s0, s1, int(res.iters), len(evals)))
        run.evals.extend((e[3], e[4]) for e in evals)
        if s1 >= deadline:
            break
    run.window_s = time.perf_counter() - t_start
    if torch.device(device).type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.trace = tracer.read()
    del gp, vag
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(not np.isfinite(s["obj"]) for s in segments)
    checks = _check(cell, seed, X, y, theta0, iters, segments, device)
    return judge.Outcome(run=run, attempted=sum(s["iters"] for s in segments),
                         failed=failed, checks=checks)


def _recorded(vag, evals: list, tracer: Tracer):
    """vag, recording each evaluation (w, f, ∇f, start, end).  The program's
    objective returns host float64 values, so each call ends synchronised."""
    def f(w):
        with tracer.span("objective"):
            t0 = time.perf_counter()
            val, g = vag(w)
            t1 = time.perf_counter()
        evals.append((np.array(w, dtype=np.float64), float(val),
                      np.array(g, dtype=np.float64), t0, t1))
        return val, g
    return f


def points_checked(seed: int, segments: list, sample: int) -> list:
    """The evaluations judged against the reference, as (segment, index):
    the first segment's first three iterations, and `sample` drawn from the
    seed among the rest."""
    flat = [(k, i) for k, s in enumerate(segments) for i in range(len(s["evals"]))]
    first = list(range(min(FIRST_EVALS, len(flat))))
    rest = np.arange(len(first), len(flat))
    g = data.rng(seed, data.SAMPLE)
    drawn = sorted(g.choice(rest, size=min(sample, rest.size), replace=False).tolist())
    return [flat[i] for i in first + drawn]


def _check(cell, seed, X, y, theta0, iters, segments, device) -> dict:
    cfg = cell.config
    ref = cell.reference()
    scg = module(cell.root, "reference", "scg")
    roles = [{} for _ in segments]
    step_gap = max(scg.replay([e[:3] for e in s["evals"]], theta0, iters, result_w=s["x"],
                              roles=r) for s, r in zip(segments, roles))
    leaves = ref.leaves(cfg)
    obj_gap = grad_gap = descent_gap = 0.0
    per_datum = float(cfg["N"] * cfg["D"])
    for k, i in points_checked(seed, segments, int(cell.traffic["sample"])):
        w, f, g, _, _ = segments[k]["evals"][i]
        role, old = roles[k].get(i, (None, None))
        f_ref, g_ref = ref.nlml_and_grad(cfg, X, y, w, device=device)
        if role == "rejected":
            if f_ref < old:
                descent_gap = max(descent_gap, (old - f_ref) / per_datum)
        elif role is not None and np.isfinite(f) and np.isfinite(g).all():
            obj_gap = max(obj_gap, abs(f - f_ref) / per_datum)
            grad_gap = max(grad_gap, judge.leaf_gap(g, g_ref, leaves))
        else:
            obj_gap = grad_gap = np.inf
        print(f"scg_segments: point {k}.{i} {role} f {f!r} f_ref {f_ref!r} from {old!r}",
              file=sys.stderr)
    return dict(step_gap=step_gap, obj_gap=obj_gap, grad_gap=grad_gap,
                descent_gap=descent_gap)
