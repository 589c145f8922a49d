"""Finite-difference gradient verification.

Counterpart of gpc_tpu/optim/checkgrad.py (COptimisable::checkGradients,
reference COptimisable.cpp:9-44): central differences at GRADCHANGE = 1e-6
and the printed analytic-vs-numerical table.  It checks the whole objective
construction, not only the differentiation.
"""

from __future__ import annotations

import numpy as np

from gpc_tpu_torch.ndlutil import GRADCHANGE


def check_gradients(value_and_grad_fn, x, step: float = GRADCHANGE,
                    verbose: bool = True):
    """Returns (analytic, numerical, max_abs_diff); value_and_grad_fn takes
    and returns float64 numpy, as the optimisers' does."""
    x = np.asarray(x, dtype=np.float64)
    _, g = value_and_grad_fn(x)
    g = np.asarray(g, dtype=np.float64)
    num = np.zeros_like(x)
    for i in range(x.size):
        xp, xm = x.copy(), x.copy()
        xp[i] += step
        xm[i] -= step
        fp, _ = value_and_grad_fn(xp)
        fm, _ = value_and_grad_fn(xm)
        num[i] = (float(fp) - float(fm)) / (2.0 * step)
    diff = float(np.max(np.abs(g - num)))
    if verbose:
        print("Numerical differences:")
        print(num)
        print("Analytic gradients:")
        print(g)
        print(f"Largest difference: {diff}")
    return g, num, diff
