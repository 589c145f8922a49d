"""Parameter priors (regularizers) on constrained parameters.

Counterpart of gpc_tpu/priors.py: a prior is a static `(kind, hyp, index)`
description whose log-probability is added to the model log-likelihood.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from gpc_tpu_torch import ndlutil


@dataclasses.dataclass(frozen=True)
class Prior:
    """kind: 'gaussian' (hyp = (precision,)), 'gamma' (hyp = (a, b)),
    'wang' (hyp = (M,)); index: the constrained parameter it attaches to."""

    kind: str
    hyp: Tuple[float, ...]
    index: int

    def log_prob(self, x):
        x = torch.as_tensor(x)
        if self.kind == "gaussian":
            (precision,) = self.hyp
            return -0.5 * precision * x * x - 0.5 * (ndlutil.LOGTWOPI - math.log(precision))
        if self.kind == "gamma":
            a, b = self.hyp
            return a * math.log(b) - math.lgamma(a) + torch.xlogy(
                torch.as_tensor(a - 1.0, dtype=x.dtype, device=x.device), x) - b * x
        if self.kind == "wang":
            (M,) = self.hyp
            return -M * torch.log(x)
        raise ValueError(f"unknown prior kind {self.kind}")

    def grad_input(self, x):
        """d logProb / dx."""
        x = torch.as_tensor(x)
        if self.kind == "gaussian":
            (precision,) = self.hyp
            return -precision * x
        if self.kind == "gamma":
            a, b = self.hyp
            return (a - 1.0) / x - b
        if self.kind == "wang":
            (M,) = self.hyp
            return -M / x
        raise ValueError(f"unknown prior kind {self.kind}")


def gaussian(precision: float = 1.0, index: int = 0) -> Prior:
    return Prior("gaussian", (float(precision),), index)


def gamma(a: float = 1e-6, b: float = 1e-6, index: int = 0) -> Prior:
    return Prior("gamma", (float(a), float(b)), index)


def wang(M: float = 1.0, index: int = 0) -> Prior:
    return Prior("wang", (float(M),), index)


def total_log_prob(priors, params: torch.Tensor):
    """Σ_i prior_i.logProb(params[prior_i.index]) — zero when no priors."""
    if not priors:
        return torch.zeros((), dtype=params.dtype, device=params.device)
    return sum(p.log_prob(params[p.index]) for p in priors)
