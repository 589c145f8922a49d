"""Constrained ↔ unconstrained parameter reparameterizations.

Counterpart of gpc_tpu/transforms.py, with the same integer transform codes
so a parameter vector and its code array mean the same in both packages.
The optimizer works on the unconstrained vector `a`; models expose
constrained parameters `x = atox(a)`.
"""

from __future__ import annotations

import numpy as np
import torch

LINEAR = 0
EXP = 1
NEGLOGLOGIT = 2
SIGMOID = 3

LIMVAL = 36.0
_EPS = float(np.finfo(np.float64).eps)

_NAMES = {LINEAR: "linear", EXP: "exp", NEGLOGLOGIT: "negLogLogit", SIGMOID: "sigmoid"}
_CODES = {v: k for k, v in _NAMES.items()}


def name_of(code: int) -> str:
    return _NAMES[code]


def code_of(name: str) -> int:
    if name not in _CODES:
        raise ValueError(f"Transform type {name} is currently unknown.")
    return _CODES[name]


def atox(code: int, a):
    """Unconstrained a → constrained x for a single transform code."""
    a = torch.as_tensor(a)
    if code == LINEAR:
        return a
    if code == EXP:
        return torch.exp(torch.clamp(a, -LIMVAL, LIMVAL))
    if code == NEGLOGLOGIT:
        soft = torch.where(a < LIMVAL, torch.logaddexp(torch.zeros_like(a), a), a)
        return torch.clamp(soft, min=float(np.exp(-LIMVAL)))
    if code == SIGMOID:
        s = 1.0 / (1.0 + torch.exp(-torch.clamp(a, -LIMVAL, LIMVAL)))
        return torch.clamp(s, _EPS, 1.0 - _EPS)
    raise ValueError(f"unknown transform code {code}")


def xtoa(code: int, x):
    """Constrained x → unconstrained a (inverse of atox)."""
    x = torch.as_tensor(x)
    if code == LINEAR:
        return x
    if code == EXP:
        return torch.log(x)
    if code == NEGLOGLOGIT:
        xs = torch.clamp(x, max=LIMVAL)
        return torch.where(x < LIMVAL, torch.log(torch.expm1(xs)), x)
    if code == SIGMOID:
        return torch.log(x) - torch.log1p(-x)
    raise ValueError(f"unknown transform code {code}")


def gradfact(code: int, x):
    """dx/da evaluated at x."""
    x = torch.as_tensor(x)
    if code == LINEAR:
        return torch.ones_like(x)
    if code == EXP:
        return x
    if code == NEGLOGLOGIT:
        return torch.where(x < LIMVAL, -torch.expm1(-x), torch.ones_like(x))
    if code == SIGMOID:
        return x * (1.0 - x)
    raise ValueError(f"unknown transform code {code}")


def _vectorized(fn, codes, v):
    """Apply per-index transforms over a flat vector; each branch is
    evaluated on the whole vector, then selected by its mask."""
    codes = np.asarray(codes, dtype=np.int32)
    v = torch.as_tensor(v)
    out = None
    for code in np.unique(codes):
        mask = torch.as_tensor(codes == code, device=v.device)
        branch = fn(int(code), v)
        out = branch * mask if out is None else torch.where(mask, branch, out)
    return v if out is None else out


def apply_atox(codes, a):
    """Vector a → vector x with per-index transform codes."""
    return _vectorized(atox, codes, a)


def apply_xtoa(codes, x):
    return _vectorized(xtoa, codes, x)


def apply_gradfact(codes, x):
    return _vectorized(gradfact, codes, x)
