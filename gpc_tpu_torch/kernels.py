"""Compositional covariance functions (the slice's kinds).

Counterpart of gpc_tpu/kernels.py for white, whitefixed, bias, rbf and the
additive compound cmpnd — the CLI default cmpnd(rbf, bias, white).  Each
kernel is static, hashable metadata plus functions of a parameter tensor p:

  compute(p, X1, X2)  cross-covariance without white noise;
  diag(p, X)          diagonal elements;
  gram(p, X)          compute(p, X, X) with its diagonal overwritten by
                      diag(p, X) — white enters only there.

Parameter layouts, defaults and transform codes are gpc_tpu's, so a theta
vector means the same in both packages.  `Rbf.compute` runs K1
(ops/gram.dist_gram) on a CUDA tensor and its plain version on the CPU;
both differentiate in p, X1 and X2.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.ops.gram import dist_gram
from gpc_tpu_torch.priors import Prior


@dataclasses.dataclass(frozen=True)
class Kern:
    """Base class: static (hashable) kernel metadata."""

    input_dim: int
    priors: Tuple[Prior, ...] = ()

    @property
    def kind(self) -> str:
        raise NotImplementedError

    @property
    def n_params(self) -> int:
        raise NotImplementedError

    def param_names(self):
        raise NotImplementedError

    def default_params(self) -> np.ndarray:
        raise NotImplementedError

    def transform_codes(self) -> np.ndarray:
        raise NotImplementedError

    def compute(self, p, X1, X2):
        raise NotImplementedError

    def diag(self, p, X):
        raise NotImplementedError

    def gram(self, p, X):
        """Symmetric Gram: compute + diagonal overwrite (CKern.h:128-144).
        The diagonal goes in out of place, so autograd may save compute's
        output for its backward."""
        return torch.diagonal_scatter(self.compute(p, X, X), self.diag(p, X))

    def with_priors(self, priors):
        return dataclasses.replace(self, priors=tuple(priors))

    @property
    def priors_global(self):
        """Priors with indices into this kernel's own parameter vector."""
        return self.priors

    def display_names(self):
        """Kind-prefixed parameter names (e.g. rbfinverseWidth)."""
        return [self.kind + n for n in self.param_names()]


def _ones(X, p):
    return torch.ones(X.shape[0], dtype=p.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class White(Kern):
    """k = δ_ij·σ²; zero everywhere in cross-compute."""

    @property
    def kind(self):
        return "white"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([np.exp(-2.0)])

    def transform_codes(self):
        return np.array([tr.EXP])

    def compute(self, p, X1, X2):
        return torch.zeros((X1.shape[0], X2.shape[0]), dtype=p.dtype, device=X1.device)

    def diag(self, p, X):
        return _ones(X, p) * p[0]


@dataclasses.dataclass(frozen=True)
class WhiteFixed(Kern):
    """As white but with a fixed, non-optimized variance."""

    fixed_variance: float = float(np.exp(-2.0))

    @property
    def kind(self):
        return "whitefixed"

    @property
    def n_params(self):
        return 0

    def param_names(self):
        return []

    def default_params(self):
        return np.zeros((0,))

    def transform_codes(self):
        return np.zeros((0,), dtype=np.int32)

    def compute(self, p, X1, X2):
        return torch.zeros((X1.shape[0], X2.shape[0]), dtype=X1.dtype, device=X1.device)

    def diag(self, p, X):
        return torch.full((X.shape[0],), self.fixed_variance, dtype=X.dtype,
                          device=X.device)


@dataclasses.dataclass(frozen=True)
class Bias(Kern):
    """k = σ² everywhere."""

    @property
    def kind(self):
        return "bias"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([np.exp(-2.0)])

    def transform_codes(self):
        return np.array([tr.EXP])

    def compute(self, p, X1, X2):
        return torch.ones((X1.shape[0], X2.shape[0]), dtype=p.dtype,
                          device=X1.device) * p[0]

    def diag(self, p, X):
        return _ones(X, p) * p[0]


@dataclasses.dataclass(frozen=True)
class Rbf(Kern):
    """k = σ²·exp(−γ/2·‖x−x'‖²); params [inverseWidth γ, variance σ²]."""

    @property
    def kind(self):
        return "rbf"

    @property
    def n_params(self):
        return 2

    def param_names(self):
        return ["inverseWidth", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        return dist_gram("rbf", p[:2], X1, X2)

    def diag(self, p, X):
        return _ones(X, p) * p[1]


@dataclasses.dataclass(frozen=True)
class _Component(Kern):
    """Heterogeneous children with offset parameter indexing."""

    components: Tuple[Kern, ...] = ()

    @property
    def n_params(self):
        return sum(c.n_params for c in self.components)

    def param_names(self):
        return [n for c in self.components for n in c.param_names()]

    def default_params(self):
        if not self.components:
            return np.zeros((0,))
        return np.concatenate([c.default_params() for c in self.components])

    def transform_codes(self):
        if not self.components:
            return np.zeros((0,), dtype=np.int32)
        return np.concatenate([c.transform_codes() for c in self.components]).astype(np.int32)

    def offsets(self):
        off = [0]
        for c in self.components:
            off.append(off[-1] + c.n_params)
        return off

    def child_slices(self, p):
        off = self.offsets()
        return [p[off[i]:off[i + 1]] for i in range(len(self.components))]

    @property
    def priors_global(self):
        """Child priors re-indexed into the compound parameter vector."""
        out = list(self.priors)
        off = self.offsets()
        for i, c in enumerate(self.components):
            for pr in c.priors_global:
                out.append(dataclasses.replace(pr, index=pr.index + off[i]))
        return tuple(out)

    def display_names(self):
        return [n for c in self.components for n in c.display_names()]


@dataclasses.dataclass(frozen=True)
class Cmpnd(_Component):
    """Additive combinator: k = Σᵢ kᵢ."""

    @property
    def kind(self):
        return "cmpnd"

    def compute(self, p, X1, X2):
        parts = self.child_slices(p)
        out = self.components[0].compute(parts[0], X1, X2)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out + c.compute(pp, X1, X2)
        return out

    def diag(self, p, X):
        parts = self.child_slices(p)
        out = self.components[0].diag(parts[0], X)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out + c.diag(pp, X)
        return out


_LEAF_TYPES = {
    "white": White,
    "whitefixed": WhiteFixed,
    "bias": Bias,
    "rbf": Rbf,
}


def make_kern(kind: str, input_dim: int, **kwargs) -> Kern:
    """Factory for the ported kinds (readKernFromStream counterpart)."""
    if kind == "cmpnd":
        return Cmpnd(input_dim=input_dim, components=tuple(kwargs["components"]))
    if kind not in _LEAF_TYPES:
        raise NotImplementedError(
            f"kernel type {kind!r} is not ported to gpc_tpu_torch yet "
            f"(ported: cmpnd, {', '.join(_LEAF_TYPES)})")
    return _LEAF_TYPES[kind](input_dim=input_dim, **kwargs)
