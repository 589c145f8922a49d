"""The precision control of an `ivm` configuration, put in the program's
place: the plain reference (reference/ivm.py) one precision step below what
the configuration states (float32 with TF32-rounded products), selecting
and training as IVM.optimise does, its SCG rounds under the program's own
optimiser.  The benchmark's runs never use it: the tests and the readings
behind the limits (benchmark/ivm_readings.py) select it in a cell's place
(`"system": "ivm_control"`) to show that the comparison that decides
`correct` fails it."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from harness.spec import module

_ROOT = Path(__file__).resolve().parents[2]     # the checkout: <root>/benchmark/systems/
PRECISION = "control"


def _ref():
    return module(_ROOT, "reference", "ivm")


def _real():
    return module(_ROOT, "systems", "ivm")


def configure(cfg: dict) -> None:
    pass


class ControlIVM:
    def __init__(self, cfg, X, y, kern_params, noise_params, device):
        self.cfg, self.X, self.y, self.device = cfg, X, y, device
        self.kern_params, self.noise_params = kern_params, noise_params
        self.log = None

    def init_and_select(self):
        st, self.order = _ref().select(self.cfg, self.X, self.y, self.kern_params,
                                       self.noise_params, self.device, PRECISION)
        if self.log is not None:
            self.log["passes"].append({"state": st, "kp": self.kern_params.copy(),
                                       "np": self.noise_params.copy()})
        return st

    def optimise(self, ext_iters, kern_iters, noise_iters):
        from gpc_tpu_torch.optim import scg

        ref, cfg, dev, rounds = _ref(), self.cfg, self.device, []
        exp = lambda a: np.exp(np.clip(a, -ref.LIMVAL, ref.LIMVAL))   # noqa: E731
        for _ in range(ext_iters):
            if kern_iters > 0:
                st = self.init_and_select()
                Xa = self.X[self.order]
                vag = _real().recorded(self.log, "kern", lambda a: ref.active_nll_and_grad(
                    cfg, Xa, st["m_site"], st["beta_site"], a, dev, PRECISION))
                res = scg(vag, ref.kern_a(self.kern_params), max_iters=kern_iters)
                self.kern_params = exp(res.x)
                rounds.append(("kern", res))
            if noise_iters > 0:
                st = self.init_and_select()
                vag = _real().recorded(self.log, "noise", lambda a: ref.noise_nll_and_grad(
                    cfg, self.y, st["mu"], st["varsigma"], a, dev, PRECISION))
                res = scg(vag, ref.noise_a(self.noise_params), max_iters=noise_iters)
                x = np.array(res.x)
                x[-1] = exp(x[-1])
                self.noise_params = x
                rounds.append(("noise", res))
        self.init_and_select()
        return rounds


def model(cfg: dict, X, y, seed: int, device: str):
    """θ₀ as the program's model takes it: the program's IVM gives it."""
    m = _real().model(cfg, X, y, seed, "cpu")
    return ControlIVM(cfg, X, y, m.kern_params.copy(), m.noise_params.copy(), device)


def start(m) -> dict:
    return {"kp": m.kern_params.copy(), "np": m.noise_params.copy()}


def restore(m, s: dict, log) -> None:
    m.kern_params, m.noise_params = s["kp"].copy(), s["np"].copy()
    m.log = log


def optimise(m, tr: dict):
    return m.optimise(int(tr["ext_iters"]), int(tr["kern_iters"]), int(tr["noise_iters"]))
