"""fGP's stateful convenience API (counterpart of gpc_tpu/interop/fgp.py,
reference mex/fGP.mex.cpp:1-318): one global GP model behind four
commands, with gpc_tpu's semantics and messages.

* ``train(kernels, X, Y, verbose=1, iters=100, device=None)`` — kernels is
  the mex's letter string (``r`` rbf, ``e`` exp, ``w`` white, ``l`` lin,
  ``B`` bias; no bias or white is added), Y one column; an FTC GP with
  centre=True, scale_data=False, learn_scales=False, trained by `iters`
  SCG iterations.  On the card, ``r``/``e`` are K1 launches and ``l`` K4.
* ``retrain(X, Y, verbose=1, iters=100)`` — new data, the same kernel,
  SCG warm-started from the previous θ, on the previous model's device.
* ``query(X, want_variance=False)`` — posterior mean (and variance) from a
  GPServer built at the first query after a (re)train.
* ``clear()`` — drop the state.

`fgp(command, *args)` dispatches by name.  `device` None means the card,
and raises without one; pass "cpu" for the CPU.
"""

from __future__ import annotations

import numpy as np

from gpc_tpu_torch import kernels as K
from gpc_tpu_torch.models.gp import GP

_KERNEL_LETTERS = {"r": K.Rbf, "e": K.Exp, "w": K.White, "l": K.Lin, "B": K.Bias}

_state: dict = {"model": None, "kern": None, "server": None}


def _build_kern(kernels: str, input_dim: int):
    comps = []
    for i, ch in enumerate(kernels):
        if ch not in _KERNEL_LETTERS:
            raise ValueError(f"The kernel string ('{kernels}') contains illegal character "
                             f"'{ch}' at position {i + 1} (unrecognised kernel type)!")
        comps.append(_KERNEL_LETTERS[ch](input_dim=input_dim))
    return K.Cmpnd(input_dim=input_dim, components=tuple(comps))


def _check_xy(X, Y):
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if X.ndim != 2 or X.size == 0:
        raise ValueError("X data: expected non-empty 2-D array")
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape != (X.shape[0], 1):
        raise ValueError(f"Y data: expected vector {X.shape[0]}x1, got {Y.shape}")
    return X, Y


def _fit(kern, X, Y, iters, device, theta=None):
    model = GP(kern, X, Y, approx="ftc", centre=True, scale_data=False,
               learn_scales=False, device=device)
    if theta is not None:
        model.theta = theta.copy()     # FTC's θ is the kernel's alone
    res = model.optimise(iters=iters)
    _state["model"] = model
    _state["kern"] = kern
    _state["server"] = None            # the posterior state re-factors lazily
    return float(res.obj)


def train(kernels: str, X, Y, verbose: int = 1, iters: int = 100, device=None):
    """fGP('train', kernels, X, Y[, verbose]) (fGP.mex.cpp:57-174); returns
    the final objective."""
    X, Y = _check_xy(X, Y)
    return _fit(_build_kern(kernels, X.shape[1]), X, Y, iters, device)


def retrain(X, Y, verbose: int = 1, iters: int = 100):
    """fGP('retrain', X, Y[, verbose]) (fGP.mex.cpp:176-254)."""
    prev = _state["model"]
    if prev is None:
        raise RuntimeError("Model was not previously trained and thus cannot be retrained!")
    X, Y = _check_xy(X, Y)
    if X.shape[1] != prev.spec.input_dim:
        raise ValueError(f"X data: expected non-empty Mx{prev.spec.input_dim} array")
    return _fit(_state["kern"], X, Y, iters, prev.device, theta=prev.theta)


def query(X, want_variance: bool = False):
    """fGP('query', X) → mean [, variance] (fGP.mex.cpp:279-318)."""
    model = _state["model"]
    if model is None:
        raise RuntimeError("Model was not previously trained and thus cannot be queried!")
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2 or X.shape[1] != model.spec.input_dim:
        raise ValueError(f"X data: expected non-empty Mx{model.spec.input_dim} array")
    if _state["server"] is None:
        # factor once, then serve the stream of queries
        from gpc_tpu_torch.serving import GPServer
        _state["server"] = GPServer(model)
    mu, var = _state["server"].predict(X)
    return (mu, var) if want_variance else mu


def clear():
    """fGP('clear') (fGP.mex.cpp:256-277)."""
    _state.update(model=None, kern=None, server=None)


def fgp(command: str, *args, **kwargs):
    """The string-dispatch gateway (mexFunction, fGP.mex.cpp:18-54)."""
    table = {"train": train, "retrain": retrain, "query": query, "clear": clear}
    if command not in table:
        raise ValueError("Usage: fgp(command, *inputs) — commands: train, retrain, "
                         "clear, query")
    return table[command](*args, **kwargs)
