"""Polack-Ribière conjugate gradients with a Wolfe-Powell line search.

Port of gpc_tpu/optim/cg.py (COptimisable::cgOptimise, reference
COptimisable.cpp:397-640, itself a C++ translation of Rasmussen's
minimize.m), line for line.  Constants SIG = 0.1, RHO = SIG/2, INT = 0.1,
EXT = 3, MAX = 20, RATIO = 10 (COptimisable.cpp:407-413).  The control loop
runs on the host in float64 numpy; `value_and_grad_fn(x)` takes the float64
vector and returns the objective and gradient from the model's device.  A
NaN or Inf objective or gradient pulls the step back by half
(COptimisable.cpp:481-523).  gpc_tpu's loop is host numpy too, so on the CPU
the iterates equal gpc_tpu's bit for bit given the same objective.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np


class CgResult(NamedTuple):
    x: np.ndarray
    obj: float
    iters: int
    func_evals: int


def cg(value_and_grad_fn: Callable, x0, max_iters: int = 1000,
       verbosity: int = 0) -> CgResult:
    INT, EXT, MAX, RATIO = 0.1, 3.0, 20, 10.0
    SIG = 0.1
    RHO = SIG / 2.0

    def vag(x):
        f, g = value_and_grad_fn(x)
        return float(f), np.asarray(g, dtype=np.float64)

    X = np.asarray(x0, dtype=np.float64).copy()
    f0, df0 = vag(X)
    func_eval = 1
    s = -df0
    d0 = -float(s @ s)
    x3 = 1.0 / (1.0 - d0)
    ls_failed = False
    iters = 0

    while iters < max_iters:
        iters += 1
        X0, F0, dF0 = X.copy(), f0, df0.copy()
        M = MAX

        # extrapolation
        x1 = x2 = 0.0
        f1 = f2 = f0
        d1 = d2 = d0
        f3, df3 = f0, df0.copy()
        while True:
            x2, f2, d2 = 0.0, f0, d0
            f3, df3 = f0, df0.copy()
            success = False
            while not success and M > 0:
                M -= 1
                func_eval += 1
                f3, df3 = vag(X + x3 * s)
                if math.isfinite(f3) and np.all(np.isfinite(df3)):
                    success = True
                else:
                    if verbosity > 1:
                        print("cgOptimise: Warning gradient or function value was NaN or inf.")
                    x3 = (x2 + x3) / 2.0          # pull back by half
            if f3 < F0:
                X0, F0, dF0 = X + x3 * s, f3, df3.copy()
            d3 = float(df3 @ s)
            if d3 > SIG * d0 or f3 > f0 + x3 * RHO * d0 or M == 0:
                break
            x1, f1, d1 = x2, f2, d2
            x2, f2, d2 = x3, f3, d3
            A = 6.0 * (f1 - f2) + 3.0 * (d2 + d1) * (x2 - x1)
            B = 3.0 * (f2 - f1) - (2.0 * d1 + d2) * (x2 - x1)
            disc = B * B - A * d1 * (x2 - x1)
            with np.errstate(invalid="ignore"):
                x3 = x1 - d1 * (x2 - x1) ** 2 / (B + math.sqrt(disc)) if disc >= 0 else float("nan")
            if not math.isfinite(x3) or x3 < 0.0 or x3 > x2 * EXT:
                x3 = x2 * EXT
            elif x3 < x2 + INT * (x2 - x1):
                x3 = x2 + INT * (x2 - x1)

        # interpolation
        x4, f4, d4 = x3, f3, d3
        while (abs(d3) > -SIG * d0 or f3 > f0 + x3 * RHO * d0) and M > 0:
            if d3 > 0 or f3 > f0 + x3 * RHO * d0:
                x4, f4, d4 = x3, f3, d3
            else:
                x2, f2, d2 = x3, f3, d3
            if f4 > f0:
                denom = f4 - f2 - d2 * (x4 - x2)
                x3 = x2 - (0.5 * d2 * (x4 - x2) ** 2) / denom if denom != 0 else float("nan")
            else:
                A = 6.0 * (f2 - f4) / (x4 - x2) + 3.0 * (d4 + d2)
                B = 3.0 * (f4 - f2) - (2.0 * d2 + d4) * (x4 - x2)
                disc = B * B - A * d2 * (x4 - x2) ** 2
                x3 = x2 + (math.sqrt(disc) - B) / A if (disc >= 0 and A != 0) else float("nan")
            if not math.isfinite(x3):
                x3 = (x2 + x4) / 2.0
            x3 = max(min(x3, x4 - INT * (x4 - x2)), x2 + INT * (x4 - x2))
            f3, df3 = vag(X + x3 * s)
            if f3 < F0:
                X0, F0, dF0 = X + x3 * s, f3, df3.copy()
            func_eval += 1
            M -= 1
            d3 = float(df3 @ s)

        # accept or reject
        if abs(d3) < -SIG * d0 and f3 < f0 + x3 * RHO * d0:
            X = X + x3 * s
            f0 = f3
            if verbosity > 2:
                print(f"Iteration: {iters} Error: {f0}")
            # Polack-Ribière direction (COptimisable.cpp:595-609)
            s = s * (float(df3 @ df3) - float(df0 @ df3)) / float(df0 @ df0) - df3
            df0 = df3.copy()
            d3_old, d0 = d0, float(df0 @ s)
            if d0 > 0:
                s = -df0
                d0 = -float(s @ s)
            x3 = x3 * min(RATIO, d3_old / (d0 - np.finfo(float).tiny))
            ls_failed = False
        else:
            X, f0, df0 = X0.copy(), F0, dF0.copy()
            if ls_failed or iters >= max_iters:
                break
            s = -df0
            d0 = -float(s @ s)
            x3 = 1.0 / (1.0 - d0)
            ls_failed = True

    return CgResult(x=X, obj=f0, iters=iters, func_evals=func_eval)
