"""An `ivm` system with one fault planted under the harness, for showing
what the comparison that decides `correct` catches.  The configuration's
`fault` names it:

  stale  the fourth pass of a segment (the one after the second kernel
         round) returns the previous pass's state unchanged;
  half   the last pass stops at d/2 steps;
  swap   at step d/2 of the last pass the point of the second largest
         entropy score is added in place of the largest;
  frozen the second iteration of every SCG round returns its state
         unchanged (systems/gp_faults.py's `frozen`).

The benchmark's runs never use it: the tests and the readings behind the
limits (benchmark/ivm_readings.py) select it in a cell's place
(`"system": "ivm_faults"`)."""

from __future__ import annotations

from pathlib import Path

import torch

from harness.spec import module

_ROOT = Path(__file__).resolve().parents[2]     # the checkout: <root>/benchmark/systems/
STALE_PASS = 3
_FAULT = {}


def _real():
    return module(_ROOT, "systems", "ivm")


def configure(cfg: dict) -> None:
    _FAULT["name"] = cfg["fault"]


def _faulty_run(sel, kern_params, noise_params, rand_vals, fault: str):
    """Selector.run with the fault: the same reset, graph and steps."""
    from gpc_tpu_torch.models.ivm import IvmState, add_point, entropy_scores, step

    sel.reset(kern_params, noise_params, rand_vals)
    c, d = sel.c, sel.spec.num_active
    cuda = c["X"].device.type == "cuda"
    if cuda and sel.graph is None:
        sel._capture()
    with torch.no_grad():
        for k in range(d // 2 if fault == "half" else d):
            if fault == "swap" and k == d // 2:
                add_point(sel.spec, c, torch.topk(entropy_scores(sel.spec, c), 2).indices[1:])
            elif cuda:
                sel.graph.replay()
            else:
                step(sel.spec, c)
    return IvmState(active_idx=c["idx"].clone(), active_mask=c["mask"].clone(),
                    m_site=c["m_site"].clone(), beta_site=c["beta_site"].clone(),
                    mu=c["mu"].clone(), varsigma=c["vs"].clone(), nu=c["nu"].clone(),
                    g=c["g"].clone())


def _faulty_class():
    base = _real()._recording_class()

    class FaultyIVM(base):
        passes = 0

        def init_and_select(self):
            k, fault = self.passes, _FAULT["name"]
            self.passes += 1
            last = 2 * self.ext_iters
            if fault == "stale" and k == STALE_PASS:
                self.note_pass(self.state)
                return self.state
            if fault in ("half", "swap") and k == last and self._selector is not None:
                sel = self._selector
                sel.run = lambda kp, np_, rv: _faulty_run(sel, kp, np_, rv, fault)
                try:
                    return super().init_and_select()
                finally:
                    del sel.run
            return super().init_and_select()

        def optimise(self, ext_iters=15, **kw):
            self.passes, self.ext_iters = 0, ext_iters
            return super().optimise(ext_iters=ext_iters, **kw)

    return FaultyIVM


def model(cfg: dict, X, y, seed: int, device: str):
    return _real().model(cfg, X, y, seed, device, cls=_faulty_class())


def start(m):
    return _real().start(m)


def restore(m, s, log):
    _real().restore(m, s, log)


def optimise(m, tr):
    if _FAULT["name"] != "frozen":
        return _real().optimise(m, tr)
    with module(_ROOT, "systems", "gp_faults")._frozen_second_step():
        return _real().optimise(m, tr)
