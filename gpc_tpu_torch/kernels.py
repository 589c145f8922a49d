"""Compositional covariance functions: every kind gpc_tpu's kernels.py has.

Counterpart of gpc_tpu/kernels.py: the leaves white, whitefixed, bias, rbf,
exp, ratquad, matern32, matern52, lin, mlp, poly and the ARD forms linard,
rbfard, mlpard, polyard, and the combinators cmpnd (sum) and tensor
(product).  Each kernel is static, hashable metadata plus functions of a
parameter tensor p:

  compute(p, X1, X2)  cross-covariance without white noise;
  diag(p, X)          diagonal elements;
  gram(p, X)          compute(p, X, X) with its diagonal overwritten by
                      diag(p, X) — white enters only there;
  white(p)            the white variance on the kernel's own diagonal.

compute, diag and gram also take inputs with leading batch axes, (..., n,
q), as gpc_tpu's vmapped Grams do: PITC's blocks go to K1/K4 in one launch.

Parameter layouts, defaults and transform codes are gpc_tpu's, so a theta
vector means the same in both packages.  The distance family (rbf, exp,
ratquad, matern32/52) computes through K1 (ops/gram.dist_gram) and the
inner-product family (lin, poly, mlp) through K4 (ops/gram.inner_gram): on
a CUDA tensor the kernel, on the CPU its plain version; both differentiate
in p, X1 and X2.  The ARD forms scale the inputs by √s in plain tensor code
before the kernel, so autograd reaches the scales s.  `diag` is plain
PyTorch.  get_variance / set_variance (the GPDM's SNR scaling, CKern.h:
489-498) read and replace the variance entry of a leaf functionally, and
cmpnd and tensor rescale their children (see `Cmpnd.set_variance` for the
one deviation from gpc_tpu).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.ops.gram import dist_gram, inner_gram
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

    @property
    def stationary(self) -> bool:
        return True

    def compute(self, p, X1, X2):
        raise NotImplementedError

    def diag(self, p, X):
        raise NotImplementedError

    def white(self, p):
        """White variance on the kernel's own symmetric diagonal."""
        return torch.zeros((), dtype=p.dtype, device=p.device)

    # index of a leaf's variance in p (None: no variance parameter)
    _variance_index = None

    def get_variance(self, p):
        """The kernel's variance (CKern::getVariance)."""
        if self._variance_index is None:
            raise NotImplementedError(f"getVariance not defined for {self.kind}")
        return p[self._variance_index]

    def set_variance(self, p, val):
        """p with the variance replaced by `val` (CKern::setVariance), out
        of place."""
        if self._variance_index is None:
            raise NotImplementedError(f"setVariance not defined for {self.kind}")
        out = p.clone()
        out[self._variance_index] = val
        return out

    def gram(self, p, X):
        """Symmetric Gram: compute + diagonal overwrite (CKern.h:128-144).
        The diagonal goes in out of place, so autograd may save compute's
        output for its backward."""
        return torch.diagonal_scatter(self.compute(p, X, X), self.diag(p, X),
                                      dim1=-2, dim2=-1)

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
    return torch.ones(X.shape[:-1], dtype=p.dtype, device=X.device)


def _cross_shape(X1, X2):
    """The shape of compute(p, X1, X2): (..., n1, n2)."""
    return (*X1.shape[:-1], X2.shape[-2])


@dataclasses.dataclass(frozen=True)
class White(Kern):
    """k = δ_ij·σ²; zero everywhere in cross-compute."""

    _variance_index = 0

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
        return torch.zeros(_cross_shape(X1, X2), dtype=p.dtype, device=X1.device)

    def diag(self, p, X):
        return _ones(X, p) * p[0]

    def white(self, p):
        return p[0]


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
        return torch.zeros(_cross_shape(X1, X2), dtype=X1.dtype, device=X1.device)

    def diag(self, p, X):
        return torch.full(X.shape[:-1], self.fixed_variance, dtype=X.dtype,
                          device=X.device)

    def white(self, p):
        return torch.tensor(self.fixed_variance, dtype=p.dtype, device=p.device)

    def get_variance(self, p):
        return torch.tensor(self.fixed_variance, dtype=p.dtype, device=p.device)

    def set_variance(self, p, val):
        # the variance is structural (not in p); Cmpnd.set_variance routes
        # around it
        raise ValueError(
            "whitefixed variance is structural, not a parameter: rebuild "
            "with dataclasses.replace(kern, fixed_variance=...)")


@dataclasses.dataclass(frozen=True)
class Bias(Kern):
    """k = σ² everywhere."""

    _variance_index = 0

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
        return torch.ones(_cross_shape(X1, X2), dtype=p.dtype,
                          device=X1.device) * p[0]

    def diag(self, p, X):
        return _ones(X, p) * p[0]


@dataclasses.dataclass(frozen=True)
class Rbf(Kern):
    """k = σ²·exp(−γ/2·‖x−x'‖²); params [inverseWidth γ, variance σ²]."""

    _variance_index = 1

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
class _Stationary2(Kern):
    """A distance-family leaf with params [p0, variance] (exp, matern32/52)."""

    _variance_index = 1

    @property
    def n_params(self):
        return 2

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        return dist_gram(self.kind, p[:2], X1, X2)

    def diag(self, p, X):
        return _ones(X, p) * p[1]


@dataclasses.dataclass(frozen=True)
class Exp(_Stationary2):
    """k = σ²·exp(−γ·‖x−x'‖); params [inverseWidth, variance]."""

    @property
    def kind(self):
        return "exp"

    def param_names(self):
        return ["inverseWidth", "variance"]


@dataclasses.dataclass(frozen=True)
class Matern32(_Stationary2):
    """k = σ²·(1+√3r/ℓ)·exp(−√3r/ℓ); params [lengthScale, variance]."""

    @property
    def kind(self):
        return "matern32"

    def param_names(self):
        return ["lengthScale", "variance"]


@dataclasses.dataclass(frozen=True)
class Matern52(_Stationary2):
    """k = σ²·(1+u+u²/3)·exp(−u), u = √5·r/ℓ; params [lengthScale, variance]."""

    @property
    def kind(self):
        return "matern52"

    def param_names(self):
        return ["lengthScale", "variance"]


@dataclasses.dataclass(frozen=True)
class RatQuad(Kern):
    """k = σ²·(1 + r²/(2αℓ²))^(−α); params [alpha, lengthScale, variance]."""

    _variance_index = 2

    @property
    def kind(self):
        return "ratquad"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["alpha", "lengthScale", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        return dist_gram("ratquad", p[:3], X1, X2)

    def diag(self, p, X):
        return _ones(X, p) * p[2]


def _mlp_diag(p, sq):
    """Mlp's diagonal from the (scaled) squared row norms sq: the arcsin
    argument clamped strictly inside [−1, 1], as compute's is."""
    numer = p[0] * sq + p[1]
    arg = numer / (numer + 1.0)
    lim = 1.0 - torch.finfo(arg.dtype).eps / 2      # 1 − epsneg
    return p[2] * torch.asin(torch.clamp(arg, -lim, lim))


@dataclasses.dataclass(frozen=True)
class Lin(Kern):
    """k = σ²·xᵀx'; params [variance]; non-stationary."""

    _variance_index = 0

    @property
    def kind(self):
        return "lin"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([1.0])

    def transform_codes(self):
        return np.array([tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("lin", p[:1], X1, X2)

    def diag(self, p, X):
        return p[0] * torch.sum(X * X, dim=-1)


@dataclasses.dataclass(frozen=True)
class Mlp(Kern):
    """Williams' arcsin kernel σ²·asin((w·xᵀx'+b)/√((w‖x‖²+b+1)(w‖x'‖²+b+1)));
    params [weightVariance, biasVariance, variance]."""

    _variance_index = 2

    @property
    def kind(self):
        return "mlp"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"]

    def default_params(self):
        return np.array([10.0, 10.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("mlp", p[:3], X1, X2)

    def diag(self, p, X):
        return _mlp_diag(p, torch.sum(X * X, dim=-1))


@dataclasses.dataclass(frozen=True)
class Poly(Kern):
    """k = σ²·(w·xᵀx'+b)^d; the degree d is static (written to the model
    file, not trained); params [weightVariance, biasVariance, variance]."""

    _variance_index = 2

    degree: float = 2.0

    @property
    def kind(self):
        return "poly"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("poly", p[:3], X1, X2, self.degree)

    def diag(self, p, X):
        return p[2] * torch.pow(p[0] * torch.sum(X * X, dim=-1) + p[1], self.degree)


# ARD forms: scales s in [0, 1] through the sigmoid transform, 0.5 at start,
# the last input_dim parameters.  compute scales both inputs by √s and hands
# them to the base kernel's Gram map.

def _ard_codes(head: int, input_dim: int) -> np.ndarray:
    return np.concatenate([[tr.EXP] * head,
                           tr.SIGMOID * np.ones(input_dim, np.int32)]).astype(np.int32)


class _ArdMixin:
    def _scales(self, p):
        return p[self.n_params - self.input_dim:]

    def _scaled(self, p, X1, X2):
        rs = torch.sqrt(self._scales(p))
        return X1 * rs, X2 * rs


@dataclasses.dataclass(frozen=True)
class Linard(_ArdMixin, Kern):
    """ARD linear σ²·Σᵢ sᵢxᵢx'ᵢ; params [variance, inputScale×D]."""

    _variance_index = 0

    @property
    def kind(self):
        return "linard"

    @property
    def n_params(self):
        return 1 + self.input_dim

    def param_names(self):
        return ["variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return _ard_codes(1, self.input_dim)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("lin", p[:1], *self._scaled(p, X1, X2))

    def diag(self, p, X):
        return p[0] * torch.sum(X * X * self._scales(p), dim=-1)


@dataclasses.dataclass(frozen=True)
class Rbfard(_ArdMixin, Kern):
    """ARD rbf σ²·exp(−γ/2·Σᵢ sᵢ(xᵢ−x'ᵢ)²); params [inverseWidth, variance,
    inputScale×D]."""

    _variance_index = 1

    @property
    def kind(self):
        return "rbfard"

    @property
    def n_params(self):
        return 2 + self.input_dim

    def param_names(self):
        return ["inverseWidth", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return _ard_codes(2, self.input_dim)

    def compute(self, p, X1, X2):
        return dist_gram("rbf", p[:2], *self._scaled(p, X1, X2))

    def diag(self, p, X):
        return _ones(X, p) * p[1]


@dataclasses.dataclass(frozen=True)
class Mlpard(_ArdMixin, Kern):
    """ARD arcsin kernel; params [weightVariance, biasVariance, variance,
    inputScale×D]."""

    _variance_index = 2

    @property
    def kind(self):
        return "mlpard"

    @property
    def n_params(self):
        return 3 + self.input_dim

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[10.0, 10.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return _ard_codes(3, self.input_dim)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("mlp", p[:3], *self._scaled(p, X1, X2))

    def diag(self, p, X):
        return _mlp_diag(p, torch.sum(X * X * self._scales(p), dim=-1))


@dataclasses.dataclass(frozen=True)
class Polyard(_ArdMixin, Kern):
    """ARD polynomial; params [weightVariance, biasVariance, variance,
    inputScale×D]; the degree is static."""

    _variance_index = 2

    degree: float = 2.0

    @property
    def kind(self):
        return "polyard"

    @property
    def n_params(self):
        return 3 + self.input_dim

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0, 1.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return _ard_codes(3, self.input_dim)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return inner_gram("poly", p[:3], *self._scaled(p, X1, X2), self.degree)

    def diag(self, p, X):
        sq = torch.sum(X * X * self._scales(p), dim=-1)
        return p[2] * torch.pow(p[0] * sq + p[1], self.degree)


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

    @property
    def stationary(self):
        return all(c.stationary for c in self.components)

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

    def white(self, p):
        w = torch.zeros((), dtype=p.dtype, device=p.device)
        for c, pp in zip(self.components, self.child_slices(p)):
            w = w + c.white(pp)
        return w

    def get_variance(self, p):
        return sum(c.get_variance(pp) for c, pp in zip(self.components, self.child_slices(p)))

    def set_variance(self, p, val):
        """Rescale the children proportionally so that the total lands on
        `val` (CKern.h:489-498).  whitefixed children hold their variance
        structurally, so, as in gpc_tpu, the other children absorb the
        change: each is scaled by (val − fixed)/(cur − fixed).  Where
        gpc_tpu's ratio breaks down this raises ValueError instead: when
        the whitefixed children hold all the variance (cur ≤ fixed, a
        division by zero that gives gpc_tpu NaN) and when val < fixed (a
        negative ratio that gives it negative variances)."""
        cur = self.get_variance(p)
        fixed = sum(float(c.fixed_variance) for c in self.components
                    if c.kind == "whitefixed")
        if float(cur) - fixed <= 0.0:
            raise ValueError(f"cmpnd setVariance: the whitefixed children hold all "
                             f"the variance ({fixed}), so the others cannot be "
                             f"rescaled")
        if float(val) < fixed:
            raise ValueError(f"cmpnd setVariance: the variance {float(val)} is below "
                             f"the fixed white variance {fixed}")
        ratio = (val - fixed) / (cur - fixed)
        out = p
        off = self.offsets()
        for i, c in enumerate(self.components):
            if c.kind == "whitefixed":
                continue
            pp = c.set_variance(out[off[i]:off[i + 1]],
                                c.get_variance(out[off[i]:off[i + 1]]) * ratio)
            out = torch.cat([out[:off[i]], pp, out[off[i + 1]:]])
        return out


@dataclasses.dataclass(frozen=True)
class Tensor(_Component):
    """Product combinator: k = Πᵢ kᵢ; white children are rejected."""

    def __post_init__(self):
        for c in self.components:
            if c.kind == "white":
                raise ValueError("Can't have white kernel components in tensor kernels.")

    @property
    def kind(self):
        return "tensor"

    def compute(self, p, X1, X2):
        parts = self.child_slices(p)
        out = self.components[0].compute(parts[0], X1, X2)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.compute(pp, X1, X2)
        return out

    def diag(self, p, X):
        parts = self.child_slices(p)
        out = self.components[0].diag(parts[0], X)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.diag(pp, X)
        return out

    def get_variance(self, p):
        parts = self.child_slices(p)
        out = self.components[0].get_variance(parts[0])
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.get_variance(pp)
        return out

    def set_variance(self, p, val):
        """Rescale EVERY child by val/total, gpc_tpu's rule (the reference's
        CTensorKern::setVariance, CKern.h:534-542): with k > 1 children the
        product lands on total·(val/total)^k, not val.  A whitefixed child
        raises through WhiteFixed.set_variance, as in gpc_tpu."""
        factor = val / self.get_variance(p)
        out = p
        off = self.offsets()
        for i, c in enumerate(self.components):
            pp = c.set_variance(out[off[i]:off[i + 1]],
                                c.get_variance(out[off[i]:off[i + 1]]) * factor)
            out = torch.cat([out[:off[i]], pp, out[off[i + 1]:]])
        return out


_LEAF_TYPES = {
    "white": White,
    "whitefixed": WhiteFixed,
    "bias": Bias,
    "rbf": Rbf,
    "exp": Exp,
    "ratquad": RatQuad,
    "matern32": Matern32,
    "matern52": Matern52,
    "lin": Lin,
    "mlp": Mlp,
    "poly": Poly,
    "linard": Linard,
    "rbfard": Rbfard,
    "mlpard": Mlpard,
    "polyard": Polyard,
}


def make_kern(kind: str, input_dim: int, **kwargs) -> Kern:
    """Factory (readKernFromStream counterpart): a leaf by kind, or a cmpnd
    or tensor of `components`."""
    if kind == "cmpnd":
        return Cmpnd(input_dim=input_dim, components=tuple(kwargs["components"]))
    if kind == "tensor":
        return Tensor(input_dim=input_dim, components=tuple(kwargs["components"]))
    if kind not in _LEAF_TYPES:
        raise ValueError(f"Unknown kernel type {kind}")
    return _LEAF_TYPES[kind](input_dim=input_dim, **kwargs)


def gram(kern: Kern, p, X):
    """kern's Gram of X (the diagonal from `diag`), as gpc_tpu.kernels.gram."""
    return kern.gram(p, X)


def cross(kern: Kern, p, X1, X2):
    """kern's cross-covariance of X1 and X2 (no white term)."""
    return kern.compute(p, X1, X2)


def diag(kern: Kern, p, X):
    """The diagonal of kern's Gram of X."""
    return kern.diag(p, X)
