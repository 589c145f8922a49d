"""Plain reference of the scaled conjugate gradient optimiser (Møller
1993) as the GPc reference trains with it (COptimisable::scgOptimise):
the curvature probe σ = 1e-4/‖p‖, the scale update δ += (λ − λ̄)·‖p‖ (‖p‖,
not ‖p‖²), the positive-definiteness repair, the step α = μ/δ, the
comparison Δ, λ halved at Δ ≥ 0.75 (floored at 1e-15) and quadrupled at
Δ < 0.25, a restart p ← r every n_params iterations, and convergence on a
successful step when |max(p)·α| < tol.  A non-finite Δ rejects the step.

`replay` follows a run of the program step by step: it reads the program's
evaluations in the order they were made, (w, f(w), ∇f(w)), proposes each
next point from the values the program got, and reports how far the
program's points depart from its own.  It judges the optimiser alone; the
values at each point are judged against the model's reference."""

from __future__ import annotations

import numpy as np


def _gap(got, want, scale):
    """‖got − want‖ over the step's own length `scale`; entries that are not
    finite must be so on both sides."""
    bad = ~np.isfinite(got)
    if not np.array_equal(bad, ~np.isfinite(want)):
        return np.inf
    diff = float(np.linalg.norm(got[~bad] - want[~bad]))
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def replay(evals, theta0, iters: int, result_w=None, tol: float = 1e-6,
           dtype=np.float64, roles=None) -> float:
    """The largest departure of the program's SCG from this one over one
    run of `iters` iterations from theta0.  `evals` is the program's list of
    (w, f, g) in order; `result_w` the point it returned.  A point is
    measured against the length of the step that led to it; an evaluation
    missing or left over, a point returned elsewhere or a different
    number of evaluations reads inf; a point both place off the finite
    numbers (a step of NaN) agrees.  `roles`, a dict, receives for each
    evaluation's index in `evals` its role, "init", "probe", "accepted" or
    "rejected" (a trial step), and the objective of the point the
    optimiser stood at when it made it."""
    it = iter(evals)
    taken = [0]

    def take():
        try:
            w_, f_, g_ = next(it)
        except StopIteration:
            return None
        taken[0] += 1
        return np.asarray(w_, dtype), dtype(f_), np.asarray(g_, dtype)

    x0 = np.asarray(theta0, dtype)
    first = take()
    if first is None:
        return np.inf
    w, old, g = first
    gap = _gap(w, x0, float(np.linalg.norm(x0)))
    note = roles.__setitem__ if roles is not None else (lambda i, v: None)
    note(0, ("init", float(old)))
    r = -g
    p = r.copy()
    s = np.zeros_like(w)
    delta, lam, lam_bar, success = dtype(1.0), dtype(1.0), dtype(0.0), True
    step = float(np.linalg.norm(x0))
    n = w.shape[0]
    with np.errstate(all="ignore"):
        for k in range(1, iters + 1):
            normp2 = np.dot(p, p)
            normp = np.sqrt(normp2)
            if success:
                sigma = dtype(1e-4) / normp
                got = take()
                if got is None:
                    return np.inf
                note(taken[0] - 1, ("probe", float(old)))
                gap = max(gap, _gap(got[0], w + sigma * p, float(np.linalg.norm(sigma * p))))
                s = (got[2] + r) / sigma
                delta = np.dot(s, p)
            s = s + (lam - lam_bar) * p
            delta = delta + (lam - lam_bar) * normp
            if delta <= 0:
                s = s + (lam - 2.0 * delta / normp2) * p
                lam_bar = 2.0 * (lam - delta / normp2)
                delta = -delta + lam * normp2
                lam = lam_bar
            mu = np.dot(p, r)
            alpha = mu / delta
            w_try = w + alpha * p
            step = float(np.linalg.norm(alpha * p))
            got = take()
            if got is None:
                return np.inf
            trial = taken[0] - 1
            gap = max(gap, _gap(got[0], w_try, step))
            f_try, g_try = got[1], got[2]
            Delta = 2.0 * delta * (old - f_try) / (mu * mu)
            if not np.isfinite(Delta):
                Delta = -np.inf
            note(trial, ("accepted" if Delta >= 0 else "rejected", float(old)))
            if Delta >= 0:
                r_new = -g_try
                if k % n == 0:
                    p_new = r_new
                else:
                    p_new = r_new + ((np.dot(r_new, r_new) - np.dot(r, r_new)) / mu) * p
                lam_new = max(lam * 0.5, 1e-15) if Delta >= 0.75 else lam
                w, r, p, old, lam_bar, success = w_try, r_new, p_new, f_try, dtype(0.0), True
            else:
                lam_new, lam_bar, success = lam, lam, False
            if Delta < 0.25:
                lam_new = lam_new * 4.0
            lam = dtype(lam_new)
            if success and abs(np.max(p) * alpha) < tol:
                break
    if next(it, None) is not None:
        return np.inf
    if result_w is not None:
        gap = max(gap, _gap(np.asarray(result_w, dtype), w, step))
    return gap
