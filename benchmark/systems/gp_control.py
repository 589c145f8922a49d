"""The precision control of a `gp` configuration, put in the program's
place: the plain reference (reference/gp.py) computed one precision step
below what the configuration states (TF32 products; a float8 factor where
the configuration holds it in bfloat16).  Its training objective runs
under the program's own optimiser entry, and its server answers requests
directly.  The benchmark's runs never use it: benchmark/control.py and the
tests select it in a cell's place (`"system": "gp_control"`) to show that
the comparison that decides `correct` fails it."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from harness.spec import module

_ROOT = Path(__file__).resolve().parents[2]     # the checkout: <root>/benchmark/systems/


def _ref():
    return module(_ROOT, "reference", "gp")


def configure(cfg: dict) -> None:
    pass


class ControlModel:
    def __init__(self, cfg, X, y, theta, device):
        self.cfg, self.X, self.y, self.theta, self.device = cfg, X, y, theta, device

    def value_and_grad_fn(self):
        ref, cfg, X, y, dev = _ref(), self.cfg, self.X, self.y, self.device
        return lambda w: ref.nlml_and_grad(cfg, X, y, np.asarray(w), device=dev,
                                           precision="control")


class ControlServer:
    def __init__(self, cfg, gp):
        self.state = _ref().posterior_state(cfg, gp.X, gp.y, gp.theta, device=gp.device,
                                            precision="control")

    def predict(self, Xt):
        return _ref().posterior(self.state, Xt)


def model(cfg: dict, X, y, seed: int, device: str):
    """θ₀ as the program's model takes it: the program's own GP gives it."""
    gp = module(_ROOT, "systems", "gp").model(cfg, X, y, seed, "cpu")
    return ControlModel(cfg, X, y, gp.theta.copy(), device)


def optimise(value_and_grad, theta0, iters: int):
    return module(_ROOT, "systems", "gp").optimise(value_and_grad, theta0, iters)


def server(cfg: dict, gp):
    return ControlServer(cfg, gp)
