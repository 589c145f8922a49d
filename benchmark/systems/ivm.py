"""The system under test for an `ivm` configuration: the port's IVM
(gpc_tpu_torch.models.ivm) as `ivm learn -o regression -k rbf -a d` builds
it, and its `IVM.optimise`, the call the CLI makes.  A subclass records
what the benchmark judges without a second path through the program: after
each selection pass the state it returned (device tensors, read after the
window) and the parameters it ran at, and each SCG round's evaluations,
by wrapping the objective the model hands to SCG."""

from __future__ import annotations

import time

import numpy as np


def configure(cfg: dict) -> None:
    pass


def kernel(cfg: dict):
    """`-k rbf`: cmpnd(rbf, bias, white) at the CLI's defaults."""
    from gpc_tpu_torch import kernels as KM

    if cfg["kernel"] != ["rbf", "bias", "white"]:
        raise ValueError(f"ivm system: kernel {cfg['kernel']} is not `-k rbf`'s")
    q = cfg["q"]
    return KM.Cmpnd(input_dim=q, components=(KM.Rbf(input_dim=q), KM.Bias(input_dim=q),
                                             KM.White(input_dim=q)))


def noise(cfg: dict):
    """`-o regression`: Gaussian noise, its parameters the defaults from y."""
    from gpc_tpu_torch.noise import GaussianNoise

    if cfg["noise_model"] != "gaussian":
        raise ValueError(f"ivm system: noise model {cfg['noise_model']!r} is not `-o regression`'s")
    return GaussianNoise(output_dim=cfg["D"])


def recorded(log, kind: str, vag):
    """vag, appending each evaluation (w, f, ∇f, start, end) to a new round
    of `log` (none where `log` is None).  The program's objective returns
    host float64 values, so each call ends synchronised."""
    if log is None:
        return vag
    evals = []
    log["rounds"].append({"kind": kind, "pass": len(log["passes"]) - 1, "evals": evals})

    def f(w):
        t0 = time.perf_counter()
        val, g = vag(w)
        t1 = time.perf_counter()
        evals.append((np.array(w, dtype=np.float64), float(val),
                      np.array(g, dtype=np.float64), t0, t1))
        return val, g
    return f


def _recording_class():
    from gpc_tpu_torch.models.ivm import IVM

    class RecordedIVM(IVM):
        """IVM whose passes and objectives are recorded into `log`."""

        log = None

        def init_and_select(self):
            st = super().init_and_select()
            self.note_pass(st)
            return st

        def note_pass(self, st):
            if self.log is not None:
                self.log["passes"].append({"state": st._asdict(), "kp": self.kern_params.copy(),
                                           "np": self.noise_params.copy()})

        def _kern_vag(self, Xa, m_site, beta_site):
            return recorded(self.log, "kern", super()._kern_vag(Xa, m_site, beta_site))

        def _noise_vag(self, mu, varsigma):
            return recorded(self.log, "noise", super()._noise_vag(mu, varsigma))

    return RecordedIVM


def model(cfg: dict, X, y, seed: int, device: str, cls=None):
    """The IVM of `ivm -s seed learn`, its parameters the CLI's defaults."""
    cls = cls or _recording_class()
    k = kernel(cfg)
    return cls(k, noise(cfg), X, y, num_active=cfg["d"], selection=cfg["selection"],
               seed=int(seed) % 2 ** 32, kern_params=k.default_params(), device=device)


def start(m) -> dict:
    """θ₀: the parameters and the MT19937 state a segment starts from."""
    return {"kp": m.kern_params.copy(), "np": m.noise_params.copy(),
            "rng": m.ref_rng.get_state()}


def restore(m, s: dict, log) -> None:
    m.kern_params, m.noise_params = s["kp"].copy(), s["np"].copy()
    m.ref_rng.set_state(*s["rng"])
    m.log = log


def optimise(m, tr: dict):
    """One segment: IVM.optimise as `ivm learn -# K -n S -e E` calls it."""
    return m.optimise(ext_iters=int(tr["ext_iters"]), kern_iters=int(tr["kern_iters"]),
                      noise_iters=int(tr["noise_iters"]))
