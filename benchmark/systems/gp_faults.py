"""A `gp` system with one fault planted under the harness, for showing that
the comparison that decides `correct` catches it.  The configuration's
`fault` names it:

  frozen   training: SCG's second iteration returns its state unchanged;
  half     training: the objective and gradient over the first half of
           the rows, doubled (half the batch left out, the mean taken over
           the rest); serving: each request's first half of rows computed,
           the rest given the mean of those;
  altered  training: one entry of every gradient (the white variance's)
           scaled by 1.5 where it is produced; serving: the first row's
           mean of every answer moved by 1 % of the answer's scale.

The benchmark's runs never use it: benchmark/control.py and the tests
select it in a cell's place (`"system": "gp_faults"`)."""

from __future__ import annotations

import contextlib
import importlib
from pathlib import Path

import numpy as np

from harness.spec import module

_ROOT = Path(__file__).resolve().parents[2]     # the checkout: <root>/benchmark/systems/


def _real():
    return module(_ROOT, "systems", "gp")


_FAULT = {}        # the fault of the configuration last configured


def configure(cfg: dict) -> None:
    _FAULT["name"] = cfg["fault"]
    _real().configure(cfg)


def _white_index(cfg) -> int:
    return (cfg["M"] * cfg["q"] if cfg["approx"] != "ftc" else 0) + 3


class _Model:
    def __init__(self, cfg, gp, scale=1.0):
        self.cfg, self.gp, self.scale, self.theta = cfg, gp, scale, gp.theta

    def value_and_grad_fn(self):
        vag = self.gp.value_and_grad_fn()
        fault, k, s = self.cfg["fault"], _white_index(self.cfg), self.scale

        def f(w):
            val, g = vag(w)
            g = np.array(g, dtype=np.float64) * s
            if fault == "altered":
                g[k] *= 1.5
            return val * s, g
        return f


def model(cfg: dict, X, y, seed: int, device: str):
    if cfg["fault"] == "half":
        h = X.shape[0] // 2
        return _Model(cfg, _real().model(cfg, X[:h], y[:h], seed, device), scale=2.0)
    return _Model(cfg, _real().model(cfg, X, y, seed, device))


@contextlib.contextmanager
def _frozen_second_step():
    # the module: gpc_tpu_torch.optim's attribute `scg` is its function
    scg = importlib.import_module("gpc_tpu_torch.optim.scg")

    step = scg._step

    def frozen(fn, st, n_params, param_tol):
        if st["iter"] == 1:
            return dict(st, iter=st["iter"] + 1)
        return step(fn, st, n_params, param_tol)
    scg._step = frozen
    try:
        yield
    finally:
        scg._step = step


def optimise(value_and_grad, theta0, iters: int):
    ctx = _frozen_second_step() if _FAULT.get("name") == "frozen" else contextlib.nullcontext()
    with ctx:
        return _real().optimise(value_and_grad, theta0, iters)


class _Server:
    def __init__(self, cfg, server):
        self.cfg, self.server = cfg, server

    def predict(self, Xt):
        fault = self.cfg["fault"]
        if fault == "half":
            h = -(-Xt.shape[0] // 2)
            mu, var = self.server.predict(Xt[:h])
            rest = Xt.shape[0] - h
            return (np.concatenate([mu, np.repeat(mu.mean(0, keepdims=True), rest, 0)]),
                    np.concatenate([var, np.repeat(var.mean(0, keepdims=True), rest, 0)]))
        mu, var = self.server.predict(Xt)
        if fault == "altered":
            mu = mu.copy()
            mu[0] += 0.01 * max(float(np.abs(mu).max()), 1.0)
        return mu, var


def server(cfg: dict, m):
    return _Server(cfg, _real().server(cfg, m.gp))
