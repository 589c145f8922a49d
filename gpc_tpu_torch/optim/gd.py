"""Gradient descent with momentum, and the backtracking variant.

Ports of gpc_tpu/optim/gd.py: `gd` is COptimisable::gdOptimise (reference
COptimisable.cpp:46-104: change ← momentum·change − rate·∇f), `gd_pullback`
is gdPullbackOptimise (COptimisable.cpp:105-169: halve the rate when the
objective rises, grow it ×1.1 on success).  gpc_tpu runs `gd` as a jitted
`lax.while_loop` over its objective; here it is a host loop over
`value_and_grad_fn` (float64 vector in, objective and gradient from the
model's device out) with the same updates, the same stopping rule (both
|Δf| < obj_tol and max|Δx| < param_tol) and the same result: the last
iterate and the objective evaluated at the iterate before it.  XLA rounds
the update in its own order, so on the CPU the iterates agree with
gpc_tpu's to the last bits, not bit for bit (tests/test_torch_optim.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class GdResult(NamedTuple):
    x: np.ndarray
    obj: float
    iters: int


def _vag(value_and_grad_fn):
    def vag(x):
        f, g = value_and_grad_fn(x)
        return float(f), np.asarray(g, dtype=np.float64)
    return vag


def gd(value_and_grad_fn: Callable, x0, max_iters: int = 1000,
       learn_rate: float = 1e-4, momentum: float = 0.9,
       param_tol: float = 1e-6, obj_tol: float = 1e-6) -> GdResult:
    vag = _vag(value_and_grad_fn)
    x = np.asarray(x0, dtype=np.float64).copy()
    change = np.zeros_like(x)
    old_obj, _ = vag(x)
    obj = old_obj
    it = 0
    converged = False
    while it < max_iters and not converged:
        obj, g = vag(x)
        if momentum > 0:
            change = momentum * (change - (learn_rate / momentum) * g)
        else:
            change = -learn_rate * g
        x_new = x + change
        diff_param = float(np.max(np.abs(x_new - x)))
        converged = abs(obj - old_obj) < obj_tol and diff_param < param_tol
        x, old_obj, it = x_new, obj, it + 1
    return GdResult(x=x, obj=obj, iters=it)


def gd_pullback(value_and_grad_fn: Callable, x0, max_iters: int = 1000,
                learn_rate: float = 1e-4, param_tol: float = 1e-6,
                obj_tol: float = 1e-6) -> GdResult:
    vag = _vag(value_and_grad_fn)
    x = np.asarray(x0, dtype=np.float64).copy()
    obj, _ = vag(x)
    it = 0
    for it in range(1, max_iters + 1):
        while True:
            old = x.copy()
            _, g = vag(x)
            x_try = x - learn_rate * g
            new_obj, _ = vag(x_try)
            if obj - new_obj < 0 or not np.isfinite(new_obj):
                learn_rate /= 2.0
            else:
                diff_obj = obj - new_obj
                x, obj = x_try, new_obj
                learn_rate *= 1.1
                break
        diff_param = np.max(np.abs(x - old))
        if diff_obj < obj_tol and diff_param < param_tol:
            break
    return GdResult(x=x, obj=obj, iters=it)
