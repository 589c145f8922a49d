"""L-BFGS: the native C++ engine driven by reverse communication.

Port of gpc_tpu/optim/lbfgs.py (COptimisable::lbfgsOptimise, reference
COptimisable.cpp:185-245).  The engine is a copy of gpc_tpu's
`native/lbfgs.cpp` (Moré-Thuente line search, m = 10 history pairs), built
at first use by the port's native-build helper (native/build.py: g++ into
`gpc_tpu_torch/_build/`) and loaded with ctypes; it owns the curvature
history and the step logic, and every objective and gradient comes from `value_and_grad_fn` (float64 vector
in, the model's device computes).  Without a C++ compiler the pure-Python
two-loop fallback runs, as in gpc_tpu.  `ENGINE_RUNS` counts the runs of
each engine ("native" or "python"), so a caller can tell which one ran.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, NamedTuple

import numpy as np

from gpc_tpu_torch.native import build

ENGINE_RUNS: collections.Counter = collections.Counter()


class LbfgsResult(NamedTuple):
    x: np.ndarray
    obj: float
    iters: int
    converged: bool


def native_lib():
    """The loaded engine, or None when it cannot be built here."""
    lib = build.load("lbfgs")
    if lib is not None:
        dp = ctypes.POINTER(ctypes.c_double)
        lib.lbfgs_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lbfgs_create.restype = ctypes.c_void_p
        lib.lbfgs_destroy.argtypes = [ctypes.c_void_p]
        lib.lbfgs_set_tols.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_int]
        lib.lbfgs_step.argtypes = [ctypes.c_void_p, dp, ctypes.c_double, dp]
        lib.lbfgs_step.restype = ctypes.c_int
        lib.lbfgs_iterations.argtypes = [ctypes.c_void_p]
        lib.lbfgs_iterations.restype = ctypes.c_long
    return lib


def lbfgs(value_and_grad_fn: Callable, x0, max_iters: int = 1000, m: int = 10,
          grad_tol: float = 1e-6) -> LbfgsResult:
    x = np.asarray(x0, dtype=np.float64).copy()
    n = x.size

    def vag(v):
        f, g = value_and_grad_fn(v)
        return float(f), np.ascontiguousarray(g, dtype=np.float64)

    lib = native_lib()
    if lib is None:
        ENGINE_RUNS["python"] += 1
        return _python_lbfgs(vag, x, max_iters, m, grad_tol)
    ENGINE_RUNS["native"] += 1
    dp = ctypes.POINTER(ctypes.c_double)
    h = lib.lbfgs_create(n, m)
    lib.lbfgs_set_tols(h, grad_tol, 1e-12, 25)
    try:
        task = 0
        evals = 0
        f = np.inf
        fbest, xbest = np.inf, x.copy()
        while task == 0 and evals < max_iters * 30:
            f, g = vag(x)
            # a non-finite f goes to the engine as it is (its Moré-Thuente
            # loop retreats toward the best endpoint); a finite f with a
            # non-finite gradient it cannot see, so that becomes +inf
            if np.isfinite(f) and not np.all(np.isfinite(g)):
                f = np.float64(np.inf)
            if np.isfinite(f) and f < fbest:
                fbest, xbest = f, x.copy()
            task = lib.lbfgs_step(h, x.ctypes.data_as(dp), ctypes.c_double(f),
                                  g.ctypes.data_as(dp))
            evals += 1
            if lib.lbfgs_iterations(h) >= max_iters:
                break
        iters = int(lib.lbfgs_iterations(h))
    finally:
        lib.lbfgs_destroy(h)
    if task == 1:
        # converged: x is the point just evaluated and f its objective
        return LbfgsResult(x=x, obj=float(f), iters=iters, converged=True)
    # a cap or a failed line search: x may hold an unevaluated trial step,
    # so return the best point evaluated
    return LbfgsResult(x=xbest, obj=float(fbest), iters=iters, converged=False)


def _python_lbfgs(vag, x, max_iters, m, grad_tol):
    """The fallback: two-loop recursion and Armijo backtracking."""
    s_hist, y_hist, rho = [], [], []
    f, g = vag(x)
    iters = 0
    converged = False
    for iters in range(1, max_iters + 1):
        if np.max(np.abs(g)) < grad_tol:
            converged = True
            break
        q = g.copy()
        alpha = []
        for s, y_, r in zip(reversed(s_hist), reversed(y_hist), reversed(rho)):
            a = r * s @ q
            alpha.append(a)
            q -= a * y_
        if y_hist:
            q *= (s_hist[-1] @ y_hist[-1]) / (y_hist[-1] @ y_hist[-1])
        for (s, y_, r), a in zip(zip(s_hist, y_hist, rho), reversed(alpha)):
            q += (a - r * y_ @ q) * s
        d = -q
        dg = d @ g
        if dg >= 0:
            d, dg = -g, -(g @ g)
        step = 1.0 if y_hist else min(1.0, 1.0 / np.max(np.abs(g)))
        ok = False
        for _ in range(30):
            f_new, g_new = vag(x + step * d)
            if np.isfinite(f_new) and f_new <= f + 1e-4 * step * dg:
                ok = True
                break
            step *= 0.5
        if not ok:
            break
        s, y_ = step * d, g_new - g
        sy = s @ y_
        if sy > 1e-10 * (y_ @ y_):
            s_hist.append(s)
            y_hist.append(y_)
            rho.append(1.0 / sy)
            if len(s_hist) > m:
                s_hist.pop(0)
                y_hist.pop(0)
                rho.pop(0)
        x = x + step * d
        f, g = f_new, g_new
    return LbfgsResult(x=x, obj=f, iters=iters, converged=converged)
