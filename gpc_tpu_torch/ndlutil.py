"""Special functions with the log-domain stability tricks the likelihoods rely on.

Counterpart of gpc_tpu/ndlutil.py in torch ops: the constants, and the
erfcx family behind the probit / NCNM / ordered noise models — Φ, log Φ,
N/Φ and log(Φ(u) − Φ(u')) evaluated through the scaled complementary error
function erfcx in the tails, with gpc_tpu's branch structure
(reference ndlutil.cpp:29-92).

Everything is dtype-polymorphic: float64 on the CPU (the parity route),
float32 on the card, where erfcx switches to its asymptotic tail earlier.
Each branch that `torch.where` does not take is evaluated on clamped
arguments that keep it finite: torch, like JAX, multiplies an untaken
branch's derivative by a zero cotangent, so an infinite derivative there
would turn the gradient into NaN.  ROBUSTADD (1e-300) rounds to 0 in
float32, as it does in gpc_tpu's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Constants mirroring reference ndlutil.h:33-41.
MATCHTOL = 1e-10
GRADCHANGE = 1e-6     # checkgrad's central-difference step
DISPEPS = 1e-14
LOGTWOPI = math.log(2.0 * math.pi)
HALFLOGTWOPI = 0.5 * LOGTWOPI
HALFSQRTTWO = 0.5 * math.sqrt(2.0)
SQRTTWOPI = math.sqrt(2.0 * math.pi)
ROBUSTADD = 1e-300    # log-of-zero guard (ndlutil.cpp:9)


def _t(x):
    """A tensor of x; numbers and numpy arrays become float64, as under JAX x64."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _erfcx_asymptotic(x):
    """erfcx(x) ≈ 1/(x√π) Σ (-1)^n (2n-1)!!/(2x²)^n for large positive x."""
    ix2 = 0.5 / (x * x)
    s = 1.0 + ix2 * (-1.0 + ix2 * (3.0 + ix2 * (-15.0 + ix2 * (105.0 + ix2 * (
        -945.0 + ix2 * 10395.0)))))
    return s / (x * math.sqrt(math.pi))


def erfcx(x):
    """Scaled complementary error function exp(x²)·erfc(x) (DERFCX,
    reference ndlfortran.f:1374-1713).  x < 0: 2·exp(x²) − erfcx(−x); 0 ≤ x
    ≤ thresh: exp(x²)·erfc(x); beyond: the 7-term asymptotic series.
    thresh is 25 in float64 and 5 in float32 (erfc underflows near 26.5 and
    5.9)."""
    x = _t(x)
    f64 = x.dtype == torch.float64
    thresh = 25.0 if f64 else 5.0
    ax = torch.abs(x)
    ax_small = torch.clamp(ax, max=thresh)        # keep the unused branch finite
    ax_big = torch.clamp(ax, min=1.0)
    sq = ax_small * ax_small
    direct = torch.exp(sq) * torch.special.erfc(ax_small)
    if not f64:
        # float32's x² rounds by up to 1e-6 relative near x = 4–5, and exp
        # carries that into erfcx (XLA's erfc cancels it inside its own
        # exp(−x²)); exp(x²) = exp(hi)·(1 + lo) with lo = x² − hi exactly
        # (Veltkamp split) keeps the direct branch within float32's rounding
        c = 4097.0 * ax_small
        hi_x = c - (c - ax_small)
        lo_x = ax_small - hi_x
        lo = ((hi_x * hi_x - sq) + 2.0 * hi_x * lo_x) + lo_x * lo_x
        direct = direct * (1.0 + lo)
    tail = _erfcx_asymptotic(ax_big)
    pos = torch.where(ax <= thresh, direct, tail)
    x2_clip = torch.clamp(x * x, max=700.0 if f64 else 85.0)
    neg = 2.0 * torch.exp(x2_clip) - pos
    return torch.where(x >= 0, pos, neg)


def ngaussian(x):
    """Standard normal density N(x; 0, 1) (ndlutil.cpp:10-16)."""
    x = _t(x)
    return torch.exp(-0.5 * x * x) / SQRTTWOPI


def cum_gaussian(x):
    """Φ(x) via erf (ndlutil.cpp:17-24)."""
    x = _t(x)
    return 0.5 * (1.0 + torch.erf(x * HALFSQRTTWO))


def inv_cum_gaussian(x):
    """Φ⁻¹(x) (ndlutil.cpp:25-28)."""
    return -math.sqrt(2.0) * erfcinv(2.0 * _t(x))


def grad_ln_cum_gaussian(x):
    """d/dx log Φ(x) = N(x)/Φ(x), erfcx-stabilized for x ≤ 0 (ndlutil.cpp:29-36).
    The branch arguments are chosen by where, not min/max, whose gradient
    splits at the x = 0 tie."""
    x = _t(x)
    zero = torch.zeros_like(x)
    xp = torch.where(x > 0, x, zero)
    xn = torch.where(x > 0, zero, x)
    pos = ngaussian(xp) / cum_gaussian(xp)
    neg = 1.0 / (SQRTTWOPI * 0.5 * erfcx(-HALFSQRTTWO * xn))
    return torch.where(x > 0, pos, neg)


def ln_cum_gaussian(x):
    """log Φ(x), erfcx-stabilized in the left tail (ndlutil.cpp:37-44)."""
    x = _t(x)
    zero = torch.zeros_like(x)
    xn = torch.where(x < 0, x, zero)
    xp = torch.where(x < 0, zero, x)
    neg = -0.5 * xn * xn + math.log(0.5) + torch.log(erfcx(-HALFSQRTTWO * xn))
    pos = torch.log(cum_gaussian(xp))
    return torch.where(x < 0, neg, pos)


def ln_cum_gauss_sum(u1, u2, w1, w2):
    """log(w1·Φ(u1) + w2·Φ(u2)) — NCNM's missing-label mixture
    (ndlutil.cpp:46-60).  The exponent of each log1p branch is ≤ 0 where
    that branch is taken; it is clamped so the other cannot overflow."""
    u1, u2, w1, w2 = (_t(v) for v in (u1, u2, w1, w2))
    both_pos = (u1 > 0) & (u2 > 0)
    direct = torch.log(w1 * cum_gaussian(u1) + w2 * cum_gaussian(u2) + ROBUSTADD)
    l1 = ln_cum_gaussian(u1)
    l2 = ln_cum_gaussian(u2)
    b1 = torch.log(w1) + l1 + torch.log1p(w2 / w1 * torch.exp(torch.clamp(l2 - l1, max=0.0)))
    b2 = torch.log(w2) + l2 + torch.log1p(w1 / w2 * torch.exp(torch.clamp(l1 - l2, max=0.0)))
    return torch.where(both_pos, direct, torch.where(u1 > u2, b1, b2))


def gauss_over_diff_cum_gaussian(x, xp, order):
    """N(x_order)/(Φ(x) − Φ(xp)) with erfcx branches (ndlutil.cpp:69-93);
    order 1 puts N(x) in the numerator, order 2 N(xp).  Each branch sees
    only arguments that keep it benign: the other would cancel down to the
    1e-300 floor and its NaN gradient would leak through where."""
    x, xp = _t(x), _t(xp)
    neg_mask = x <= 0
    xn = torch.where(neg_mask, x, torch.full_like(x, -1.0))
    xpn = torch.where(neg_mask, xp, torch.full_like(xp, -2.0))
    xq = torch.where(neg_mask, torch.ones_like(x), x)
    xpq = torch.where(neg_mask, torch.zeros_like(xp), xp)
    if order == 1:
        er_n = torch.exp(0.5 * (xn * xn - xpn * xpn))
        neg = 2.0 / (SQRTTWOPI * (erfcx(-HALFSQRTTWO * xn)
                                  - er_n * erfcx(-HALFSQRTTWO * xpn) + ROBUSTADD))
        er_p = torch.exp(0.5 * (xq * xq - xpq * xpq))
        pos = 2.0 / (SQRTTWOPI * (er_p * erfcx(HALFSQRTTWO * xpq)
                                  - erfcx(HALFSQRTTWO * xq) + ROBUSTADD))
    elif order == 2:
        er_n = torch.exp(0.5 * (xpn * xpn - xn * xn))
        neg = 2.0 / (SQRTTWOPI * (er_n * erfcx(-HALFSQRTTWO * xn)
                                  - erfcx(-HALFSQRTTWO * xpn) + ROBUSTADD))
        er_p = torch.exp(0.5 * (xpq * xpq - xq * xq))
        pos = 2.0 / (SQRTTWOPI * (erfcx(HALFSQRTTWO * xpq)
                                  - er_p * erfcx(HALFSQRTTWO * xq) + ROBUSTADD))
    else:
        raise ValueError("order must be 1 or 2")
    return torch.where(neg_mask, neg, pos)


def ln_diff_cum_gaussian(u, uprime):
    """log(Φ(u) − Φ(u')) — the ordered noise's ladder terms (ndlutil.cpp:62-68)."""
    u = _t(u)
    arg = gauss_over_diff_cum_gaussian(u, uprime, 1) + ROBUSTADD
    return -torch.log(arg) - 0.5 * u * u - HALFLOGTWOPI


def sigmoid(x):
    return torch.sigmoid(_t(x))


def inv_sigmoid(x):
    x = _t(x)
    return torch.log(x) - torch.log1p(-x)


def erfcinv(x):
    """Inverse of erfc: erfcinv(x) = −Φ⁻¹(x/2)/√2."""
    return -torch.special.ndtri(_t(x) * 0.5) / math.sqrt(2.0)


def gamma(x):
    """Γ(x) for positive arguments (LGAMA wrapper parity, ndlutil.cpp:142-150)."""
    return torch.exp(torch.special.gammaln(_t(x)))


def gammaln(x):
    return torch.special.gammaln(_t(x))


def digamma(x):
    return torch.special.digamma(_t(x))


def xlogy(x, y):
    return torch.special.xlogy(_t(x), _t(y))
