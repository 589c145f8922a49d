"""Møller's Scaled Conjugate Gradient — the reference's default trainer.

Port of gpc_tpu/optim/scg.py (COptimisable::scgOptimise, reference
COptimisable.cpp:246-396) with the same iteration body.  gpc_tpu's jitted
`lax.while_loop` and `lax.cond`s become a host loop with `if`s.  Kept as in
gpc_tpu, for learned-hyperparameter parity:

  * curvature probe σ = 1e-4/‖p‖ and the finite-difference Hessian-vector
    product s = (∇f(w+σp) − ∇f(w))/σ             (COptimisable.cpp:302-315)
  * the scale update δ += (λ−λ̄)·‖p‖ — ‖p‖, not Møller's ‖p‖²
                                                  (COptimisable.cpp:318-320)
  * PD repair, step α = μ/δ, comparison Δ, λ halving at Δ ≥ 0.75 (floored
    at 1e-15) and ×4 growth at Δ < 0.25           (COptimisable.cpp:322-380)
  * one value_and_grad at w_try, its gradient reused on success
  * restart p ← r every n_params iterations       (COptimisable.cpp:353-355)
  * convergence, on a successful step only, when |max(p)·α| < param_tol
                                                  (COptimisable.cpp:385-393)
  * a NaN/Inf objective maps Δ to −∞, so the step is rejected and λ grows.

Precision: SCG's own vectors (w, r, p, s) and scalars stay float64 numpy on
the host.  `value_and_grad_fn(w)` takes the float64 vector and returns the
objective and gradient from the device in its working dtype (float32 on the
card, float64 on the CPU); they are cast to float64 here.  On the CPU the
port and gpc_tpu therefore do the same float64 arithmetic, rounded the same
way: XLA's CPU code computes a + b·c as one fused multiply-add and Σ aᵢbᵢ
as a BLAS-style dot, so this module does too (`_fma`, `np.dot`).  That
matters because the curvature probe divides by σ ≈ 1e-4/‖p‖: a one-ulp
difference in w + σp becomes a 1e-12 relative difference in s, and SCG
amplifies it over its iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

# the state fields, with gpc_tpu's names (its checkpoint files use them)
STATE_KEYS = ("w", "r", "p", "s", "delta", "old_obj", "lam", "lam_bar",
              "success", "iter", "converged")


class ScgResult(NamedTuple):
    x: np.ndarray         # optimized parameter vector
    obj: float            # final objective value
    iters: int            # iterations executed
    converged: bool       # True if tolerance met before max_iters


def _two_sum(a, b):
    """s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp split of a float64 into two 26-bit halves."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c):
    """a·b + c rounded once, as a hardware fused multiply-add: the exact
    product (Dekker), then the three-term sum with its low part rounded to
    odd (Boldo & Melquiond 2008), exact for operands far from overflow and
    underflow."""
    a, b, c = (np.asarray(t, dtype=np.float64) for t in (a, b, c))
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, ph)
    v, e = _two_sum(tl, pl)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((e != 0) & even, np.nextafter(v, np.where(e > 0, np.inf, -np.inf)), v)
    out = th + v
    return out if out.ndim else np.float64(out)


def _value_and_grad(fn, w):
    f, g = fn(w)
    return np.float64(f), np.asarray(g, dtype=np.float64).reshape(-1)


def _init(fn, x0) -> dict:
    w = np.array(x0, dtype=np.float64).reshape(-1)
    obj0, g0 = _value_and_grad(fn, w)
    return dict(w=w, r=-g0, p=-g0, s=np.zeros_like(w), delta=np.float64(1.0),
                old_obj=obj0, lam=np.float64(1.0), lam_bar=np.float64(0.0),
                success=True, iter=0, converged=False)


def _state_from(saved: dict) -> dict:
    """A state from saved arrays (a checkpoint of either package)."""
    st = {k: np.asarray(saved[k]) for k in STATE_KEYS}
    for k in ("w", "r", "p", "s"):
        st[k] = st[k].astype(np.float64).reshape(-1)
    for k in ("delta", "old_obj", "lam", "lam_bar"):
        st[k] = np.float64(st[k])
    st["success"], st["converged"] = bool(st["success"]), bool(st["converged"])
    st["iter"] = int(st["iter"])
    return st


def _step(fn, st: dict, n_params: int, param_tol: float) -> dict:
    """One SCG iteration (gpc_tpu/optim/scg.py::_make_body)."""
    it = st["iter"] + 1                    # 1-based like the reference
    w, r, p = st["w"], st["r"], st["p"]
    normp2 = np.dot(p, p)
    normp = np.sqrt(normp2)

    if st["success"]:                      # curvature probe
        sigma = 1e-4 / normp
        _, g_plus = _value_and_grad(fn, _fma(sigma, p, w))
        s = (g_plus + r) / sigma           # (∇f(w+σp) − ∇f(w))/σ, r = −∇f(w)
        delta = np.dot(s, p)
    else:
        s, delta = st["s"], st["delta"]

    lam_diff = st["lam"] - st["lam_bar"]
    s = _fma(lam_diff, p, s)
    delta = _fma(lam_diff, normp, delta)   # sic: ‖p‖, COptimisable.cpp:320

    lam, lam_bar = st["lam"], st["lam_bar"]
    if delta <= 0.0:                       # PD repair
        d_over = delta / normp2
        s = _fma(_fma(-2.0, d_over, lam), p, s)
        lam_bar = 2.0 * (lam - d_over)
        delta = _fma(lam, normp2, -delta)
        lam = lam_bar

    mu = np.dot(p, r)
    alpha = mu / delta
    w_try = _fma(alpha, p, w)
    new_obj, g_try = _value_and_grad(fn, w_try)
    Delta = 2.0 * delta * (st["old_obj"] - new_obj) / (mu * mu)
    if not np.isfinite(Delta):
        Delta = -np.inf

    if Delta >= 0.0:
        rp = -g_try
        if it % n_params == 0:
            p_n = rp
        else:
            beta = (np.dot(rp, rp) - np.dot(r, rp)) / mu
            p_n = _fma(beta, p, rp)
        lam_n = max(lam * 0.5, 1e-15) if Delta >= 0.75 else lam
        w_n, r_n, obj_n, lam_bar_n, success_n = w_try, rp, new_obj, np.float64(0.0), True
    else:
        w_n, r_n, p_n, obj_n, lam_n, lam_bar_n, success_n = w, r, p, st["old_obj"], lam, lam, False
    if Delta < 0.25:
        lam_n = lam_n * 4.0

    converged = success_n and bool(np.abs(np.max(p_n) * alpha) < param_tol)
    return dict(w=w_n, r=r_n, p=p_n, s=s, delta=np.float64(delta), old_obj=obj_n,
                lam=np.float64(lam_n), lam_bar=np.float64(lam_bar_n),
                success=success_n, iter=it, converged=converged)


def _run(fn, st, iter_end, n_params, param_tol):
    with np.errstate(all="ignore"):        # non-finite values are handled above
        while st["iter"] < iter_end and not st["converged"]:
            st = _step(fn, st, n_params, param_tol)
    return st


def _result(st) -> ScgResult:
    return ScgResult(x=st["w"], obj=float(st["old_obj"]), iters=st["iter"],
                     converged=st["converged"])


def scg(value_and_grad_fn: Callable, x0, max_iters: int = 1000,
        param_tol: float = 1e-6, obj_tol: float = 1e-6) -> ScgResult:
    """Minimize value_and_grad_fn (returning (obj, grad)) from x0.

    Defaults mirror COptimisable.h:29-36 (1000 iterations, tolerances 1e-6).
    obj_tol is accepted for signature parity: the reference's objective test
    is vacuous (module docstring of gpc_tpu/optim/scg.py)."""
    with np.errstate(all="ignore"):
        st = _init(value_and_grad_fn, x0)
    st = _run(value_and_grad_fn, st, max_iters, st["w"].shape[0], param_tol)
    return _result(st)


def scg_checkpointed(value_and_grad_fn: Callable, x0, max_iters: int = 1000,
                     param_tol: float = 1e-6, obj_tol: float = 1e-6,
                     ckpt_every: int = 50, on_checkpoint=None,
                     resume_state=None) -> ScgResult:
    """scg() in `ckpt_every`-iteration segments, with the full state handed
    to `on_checkpoint(step, state_dict)` between segments, so a killed run
    resumes (pass the saved dict back as `resume_state`) on the identical
    trajectory.  state_dict maps STATE_KEYS to numpy arrays, as gpc_tpu's
    does, so either package resumes from the other's checkpoint."""
    if resume_state is None:
        with np.errstate(all="ignore"):
            st = _init(value_and_grad_fn, x0)
    else:
        st = _state_from(resume_state)
    n_params = st["w"].shape[0]
    while st["iter"] < max_iters and not st["converged"]:
        iter_end = min(st["iter"] + int(ckpt_every), max_iters)
        st = _run(value_and_grad_fn, st, iter_end, n_params, param_tol)
        if on_checkpoint is not None:
            on_checkpoint(st["iter"], {k: np.asarray(st[k]) for k in STATE_KEYS})
    return _result(st)


def scg_minimize(fn: Callable, x0, max_iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, jit: bool = True) -> ScgResult:
    """scg() of a scalar objective fn(x) of a float64 CPU tensor x, its
    gradient from torch.autograd (optim.numpy_value_and_grad).  `jit` is
    accepted for gpc_tpu's signature and has no effect: the port runs
    eagerly."""
    from gpc_tpu_torch.optim import numpy_value_and_grad

    del jit
    return scg(numpy_value_and_grad(fn, "cpu"), np.asarray(x0, dtype=np.float64),
               max_iters=max_iters, param_tol=param_tol, obj_tol=obj_tol)
