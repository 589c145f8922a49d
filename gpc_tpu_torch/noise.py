"""Noise models (likelihoods): gaussian / scale / probit / ncnm / ordered.

Counterpart of gpc_tpu/noise.py (reference CNoise.{h,cpp}).  Each model is
a frozen dataclass of static metadata, holding no tensor, with functions of
(p, mu, varsigma, y) — p the noise parameters, mu and varsigma the posterior
moments (N, D), y the targets (N, D), all tensors on one device in one
dtype:

  * log_likelihood — Σ log p(y|f) under N(f; mu, varsigma)
  * grad_inputs    — (∂logZ/∂mu, ∂logZ/∂varsigma) per point (getGradInputs)
  * nu_g           — ADF ν = g_mu² − 2·g_vs with the reference's clamps, and g
                     (CNoise::getNuG, CNoise.cpp:5-38)
  * update_sites   — site precision β = ν/(1−ν·ς) and mean m = μ + g/ν
                     (CNoise::updateSites, CNoise.cpp:40-63; Gaussian
                     overrides with β = 1/σ², m = y − bias)
  * out / likelihoods / test_metric — predictions and per-point probabilities

The classification paths run through the erfcx family of ndlutil.py.  No
function reads a value back to the host, so the IVM's selection step, which
calls nu_g and update_sites, captures in a CUDA graph.  Missing data: NCNM
treats y ∉ {−1, 1} as unlabelled; ordered treats NaN as missing.
`default_params` takes and returns numpy, as gpc_tpu's does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpc_tpu_torch import ndlutil as nu_
from gpc_tpu_torch import transforms as tr

SMALLVAL = 1e-6  # ndlutil.h:35
_EPS = float(np.finfo(np.float64).eps)


@dataclasses.dataclass(frozen=True)
class Noise:
    """Base static noise description."""

    output_dim: int

    @property
    def kind(self):
        raise NotImplementedError

    @property
    def n_params(self):
        raise NotImplementedError

    def transform_codes(self):
        return np.zeros((self.n_params,), dtype=np.int32)

    @property
    def log_concave(self):
        return True

    @property
    def spherical(self):
        return False

    @property
    def missing(self):
        return False

    @property
    def sigma2_fixed(self):
        """Fixed (non-trainable) observation variance added to varsigma."""
        return 1e-6

    def default_params(self, y=None):
        raise NotImplementedError

    def log_likelihood(self, p, mu, varsigma, y):
        raise NotImplementedError

    def grad_inputs(self, p, mu, varsigma, y):
        """(gmu, gvs), each (N, D)."""
        raise NotImplementedError

    def nu_g(self, p, mu, varsigma, y):
        """ADF ν and g with the reference's clamp order (CNoise.cpp:19-33):
        a NEGATIVE ν of a non-log-concave model becomes SMALLVAL, which then
        survives the |ν| < SMALLVAL test; a tiny positive ν becomes EPS."""
        gmu, gvs = self.grad_inputs(p, mu, varsigma, y)
        nu = gmu * gmu - 2.0 * gvs
        if not self.log_concave:
            nu = torch.where(nu < 0.0, SMALLVAL, nu)
        nu = torch.where(torch.abs(nu) < SMALLVAL, _EPS, nu)
        return nu, gmu

    def update_sites(self, p, mu, varsigma, y, nu, g):
        """Generic ADF site update (CNoise.cpp:40-63)."""
        beta = nu / (1.0 - nu * varsigma)
        m = mu + g / nu
        return m, beta

    def out(self, p, mu, varsigma):
        raise NotImplementedError

    def likelihoods(self, p, mu, varsigma, y):
        raise NotImplementedError


# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GaussianNoise(Noise):
    """Gaussian: per-output bias and a shared σ²; params [bias×D, σ²]
    (CNoise.h:301-396; logLik CNoise.cpp:513-536)."""

    @property
    def kind(self):
        return "gaussian"

    @property
    def n_params(self):
        return self.output_dim + 1

    def transform_codes(self):
        c = np.zeros((self.n_params,), dtype=np.int32)
        c[-1] = tr.EXP
        return c

    @property
    def spherical(self):
        return True

    def default_params(self, y=None):
        bias = np.mean(y, axis=0) if y is not None else np.zeros(self.output_dim)
        return np.concatenate([bias, [1e-6]])

    def _split(self, p):
        return p[:self.output_dim], p[self.output_dim]

    def log_likelihood(self, p, mu, varsigma, y):
        bias, sigma2 = self._split(p)
        var = varsigma + sigma2
        arg = (y - mu - bias[None, :]) ** 2 / var
        L = torch.sum(torch.log(var) + arg) + mu.numel() * nu_.LOGTWOPI
        return -0.5 * L

    def grad_inputs(self, p, mu, varsigma, y):
        bias, sigma2 = self._split(p)
        nu = 1.0 / (sigma2 + varsigma)
        gmu = (y - mu - bias[None, :]) * nu
        gvs = 0.5 * (gmu * gmu - nu)
        return gmu, gvs

    def update_sites(self, p, mu, varsigma, y, nu, g):
        """β = 1/σ², m = y − bias (CNoise.cpp:454-463)."""
        bias, sigma2 = self._split(p)
        beta = torch.zeros_like(mu) + 1.0 / sigma2
        m = y - bias[None, :]
        return m, beta

    def out(self, p, mu, varsigma):
        bias, _ = self._split(p)
        return mu + bias[None, :]

    def out_std(self, p, mu, varsigma):
        _, sigma2 = self._split(p)
        return torch.sqrt(varsigma + sigma2)

    def likelihoods(self, p, mu, varsigma, y):
        bias, sigma2 = self._split(p)
        var = varsigma + sigma2
        arg = y - mu - bias[None, :]
        return torch.exp(-0.5 * arg * arg / var) / torch.sqrt(2 * math.pi * var)

    def test_metric(self, p, mu, varsigma, y):
        """Per-output MSE (CNoise.cpp:464-473)."""
        pred = self.out(p, mu, varsigma)
        return torch.mean((pred - y) ** 2, dim=0)


@dataclasses.dataclass(frozen=True)
class ScaleNoise(Noise):
    """Scaled Gaussian (the GP-LVM's preprocessing as noise); params
    [bias×D, scale×D] (CNoise.h:399-494).  No gradients: the reference
    throws there, and the GP-LVM handles its scales itself."""

    @property
    def kind(self):
        return "scale"

    @property
    def n_params(self):
        return 2 * self.output_dim

    @property
    def spherical(self):
        return True

    def default_params(self, y=None):
        if y is not None:
            bias = np.mean(y, axis=0)
            scale = np.maximum(np.std(y, axis=0, ddof=1), _EPS)
        else:
            bias = np.zeros(self.output_dim)
            scale = np.ones(self.output_dim)
        return np.concatenate([bias, scale])

    def _split(self, p):
        return p[:self.output_dim], p[self.output_dim:]

    def out(self, p, mu, varsigma):
        bias, scale = self._split(p)
        return mu * scale[None, :] + bias[None, :]


def _sign_out(bias, mu):
    """+1 where mu > −bias, else −1, in mu's dtype."""
    return torch.where(mu > -bias[None, :], 1.0, -1.0).to(mu.dtype)


@dataclasses.dataclass(frozen=True)
class ProbitNoise(Noise):
    """Probit classification: ln Φ(y·(μ+b)/√(ς+σ²)); params [bias×D], σ² =
    1e-6 fixed (CNoise.h:497-571; logLik CNoise.cpp:998-1018)."""

    @property
    def kind(self):
        return "probit"

    @property
    def n_params(self):
        return self.output_dim

    def default_params(self, y=None):
        if y is not None:
            frac = np.mean(np.asarray(y) == 1.0, axis=0)
            frac = np.clip(frac, 1e-12, 1 - 1e-12)
            return nu_.inv_cum_gaussian(frac).numpy().reshape(-1)
        return np.zeros(self.output_dim)

    def log_likelihood(self, p, mu, varsigma, y):
        c = 1.0 / torch.sqrt(varsigma + self.sigma2_fixed)
        return torch.sum(nu_.ln_cum_gaussian(y * (mu + p[None, :]) * c))

    def grad_inputs(self, p, mu, varsigma, y):
        c = y / torch.sqrt(self.sigma2_fixed + varsigma)
        u = c * (mu + p[None, :])
        gmu = nu_.grad_ln_cum_gaussian(u) * c
        gvs = -0.5 * c * u * gmu
        return gmu, gvs

    def out(self, p, mu, varsigma):
        return _sign_out(p, mu)

    def likelihoods(self, p, mu, varsigma, y):
        arg = y * (mu + p[None, :]) / torch.sqrt(varsigma + self.sigma2_fixed)
        return nu_.cum_gaussian(arg)

    def test_metric(self, p, mu, varsigma, y):
        """Per-output classification error fraction (CNoise.cpp:935-954), in
        float32 as XLA computes it (the count times float32 1/N): gpc_tpu's
        jnp.mean of a bool array is float32 even under x64, and its `ivm
        test` prints that number."""
        pred = self.out(p, mu, varsigma)
        wrong = torch.sum((pred != y).to(torch.float32), dim=0)
        return wrong * (1.0 / y.shape[0])


@dataclasses.dataclass(frozen=True)
class NcnmNoise(Noise):
    """Null-category noise model (semi-supervised classification).

    Params [bias×D, γ₋ (, γ₊ if split)], γ sigmoid-transformed; width fixed
    (default 1), σ² = 1e-6 fixed (CNoise.h:574-665; logLik CNoise.cpp:
    1334-1375).  y = +1/−1 labelled, anything else unlabelled."""

    split_gamma: bool = False
    width: float = 1.0
    sigma2: float = 1e-6

    @property
    def kind(self):
        return "ncnm"

    @property
    def n_params(self):
        return self.output_dim + (2 if self.split_gamma else 1)

    def transform_codes(self):
        c = np.zeros((self.n_params,), dtype=np.int32)
        c[self.output_dim:] = tr.SIGMOID
        return c

    @property
    def log_concave(self):
        return False

    @property
    def missing(self):
        return True

    @property
    def sigma2_fixed(self):
        return self.sigma2

    def default_params(self, y=None):
        if y is not None:
            y = np.asarray(y)
            n1 = np.sum(y == 1.0, axis=0).astype(float)
            n2 = np.sum(y == -1.0, axis=0).astype(float)
            nmiss = y.shape[0] - n1 - n2
            bias = nu_.inv_cum_gaussian(
                np.clip(n1 / np.maximum(n1 + n2, 1.0), 1e-12, 1 - 1e-12)).numpy().reshape(-1)
            gamma = float(np.mean(nmiss) / y.shape[0])
        else:
            bias = np.zeros(self.output_dim)
            gamma = 0.5
        gamma = min(max(gamma, 1e-6), 1 - 1e-6)
        g = [gamma, gamma] if self.split_gamma else [gamma]
        return np.concatenate([bias, g])

    def _split(self, p):
        bias = p[:self.output_dim]
        gamman = p[self.output_dim]
        gammap = p[self.output_dim + 1] if self.split_gamma else gamman
        return bias, gamman, gammap

    def _branches(self, p, mu, varsigma, y):
        bias, gamman, gammap = self._split(p)
        hw = self.width / 2.0
        c = 1.0 / torch.sqrt(self.sigma2_fixed + varsigma)
        mu_adj = mu + bias[None, :]
        return bias, gamman, gammap, hw, c, mu_adj, y == 1.0, y == -1.0

    def log_likelihood(self, p, mu, varsigma, y):
        bias, gamman, gammap, hw, c, mu_adj, pos, neg = self._branches(p, mu, varsigma, y)
        l_pos = nu_.ln_cum_gaussian((mu_adj - hw) * c) + torch.log(1.0 - gammap)
        l_neg = nu_.ln_cum_gaussian(-(mu_adj + hw) * c) + torch.log(1.0 - gamman)
        u = (mu_adj + hw) * c
        uprime = (mu_adj + hw - self.width) * c
        l_miss = nu_.ln_cum_gauss_sum(-u, uprime, gamman, gammap)
        return torch.sum(torch.where(pos, l_pos, torch.where(neg, l_neg, l_miss)))

    def grad_inputs(self, p, mu, varsigma, y):
        bias, gamman, gammap, hw, c, mu_adj, pos, neg = self._branches(p, mu, varsigma, y)
        # positive branch (CNoise.cpp:1244-1252)
        up = (mu_adj - hw) * c
        gmu_p = nu_.grad_ln_cum_gaussian(up) * c
        gvs_p = -0.5 * c * up * gmu_p
        # negative branch
        un = (mu_adj + hw) * c
        gmu_n = -nu_.grad_ln_cum_gaussian(-un) * c
        gvs_n = -0.5 * c * un * gmu_n
        # missing branch (CNoise.cpp:1253-1270)
        u = un
        uprime = (mu_adj + hw - self.width) * c
        lndenom = nu_.ln_cum_gauss_sum(-u, uprime, gamman, gammap)
        B1 = torch.exp(torch.log(gamman) - nu_.HALFLOGTWOPI - 0.5 * u * u - lndenom)
        B2 = torch.exp(torch.log(gammap) - nu_.HALFLOGTWOPI - 0.5 * uprime * uprime - lndenom)
        gmu_m = c * (B2 - B1)
        gvs_m = -0.5 * c * c * (uprime * B2 - u * B1)
        gmu = torch.where(pos, gmu_p, torch.where(neg, gmu_n, gmu_m))
        gvs = torch.where(pos, gvs_p, torch.where(neg, gvs_n, gvs_m))
        return gmu, gvs

    def out(self, p, mu, varsigma):
        return _sign_out(p[:self.output_dim], mu)

    def likelihoods(self, p, mu, varsigma, y):
        bias = p[:self.output_dim]
        c = 1.0 / torch.sqrt(self.sigma2_fixed + varsigma)
        arg = (mu + bias[None, :]) * c
        return torch.where(y == 1.0, nu_.cum_gaussian(arg),
                           torch.where(y == -1.0, nu_.cum_gaussian(-arg), 1.0))


@dataclasses.dataclass(frozen=True)
class OrderedNoise(Noise):
    """Ordered categorical (ordinal regression) with numCats categories.

    Params [bias×D, widths×(C−2)] (widths exp-transformed, init 1/(C−2));
    σ² = 0.1 fixed (COrderedNoise::initStoreage).  Categories are 0..C−1;
    NaN targets are missing (CNoise.h:666-762; logLik CNoise.cpp:1727+)."""

    num_categories: int = 3

    @property
    def kind(self):
        return "ordered"

    @property
    def n_params(self):
        return self.output_dim + self.num_categories - 2

    def transform_codes(self):
        c = np.zeros((self.n_params,), dtype=np.int32)
        c[self.output_dim:] = tr.EXP
        return c

    @property
    def missing(self):
        return True

    @property
    def sigma2_fixed(self):
        return 0.1

    def default_params(self, y=None):
        bias = (np.nanmean(y, axis=0) if y is not None
                else np.zeros(self.output_dim))
        nw = self.num_categories - 2
        widths = np.full(nw, 1.0 / max(nw, 1))
        return np.concatenate([bias, widths])

    def _split(self, p):
        return p[:self.output_dim], p[self.output_dim:]

    def _adjusted(self, p, mu, varsigma, y):
        bias, widths = self._split(p)
        c = 1.0 / torch.sqrt(self.sigma2_fixed + varsigma)
        t = torch.where(torch.isnan(y), 0.0, y).to(torch.int64)
        # cumulative width subtracted for category t: Σ_{k<t−1} widths_k
        cumw = torch.cat([torch.zeros(1, dtype=p.dtype, device=p.device),
                          torch.cumsum(widths, dim=0)])
        sub = cumw[torch.clamp(t - 1, 0, self.num_categories - 2)]
        mu_adj = mu + bias[None, :] - sub
        if self.num_categories > 2:
            w_t = widths[torch.clamp(t - 1, 0, max(self.num_categories - 3, 0))]
        else:
            w_t = torch.zeros_like(mu)
        return bias, widths, c, t, mu_adj, w_t

    def log_likelihood(self, p, mu, varsigma, y):
        bias, widths, c, t, mu_adj, w_t = self._adjusted(p, mu, varsigma, y)
        C = self.num_categories
        l_low = nu_.ln_cum_gaussian(-(mu + bias[None, :]) * c)      # t == 0
        u = mu_adj * c
        uprime = (mu_adj - w_t) * c
        l_mid = nu_.ln_diff_cum_gaussian(u, uprime)                  # 0 < t < C−1
        l_high = nu_.ln_cum_gaussian(mu_adj * c)                     # t == C−1
        L = torch.where(t == 0, l_low, torch.where(t == C - 1, l_high, l_mid))
        L = torch.where(torch.isnan(y), 0.0, L)
        return torch.sum(L)

    def grad_inputs(self, p, mu, varsigma, y):
        bias, widths, c, t, mu_adj, w_t = self._adjusted(p, mu, varsigma, y)
        C = self.num_categories
        # t == 0 (CNoise.cpp:1589-1595)
        u0 = (mu + bias[None, :]) * c
        gmu_0 = -c * nu_.grad_ln_cum_gaussian(-u0)
        gvs_0 = -0.5 * gmu_0 * c * u0
        # middle (CNoise.cpp:1597-1608)
        u = mu_adj * c
        uprime = (mu_adj - w_t) * c
        B1 = nu_.gauss_over_diff_cum_gaussian(u, uprime, 1)
        B2 = nu_.gauss_over_diff_cum_gaussian(u, uprime, 2)
        gmu_m = c * (B1 - B2)
        gvs_m = -0.5 * c * c * (u * B1 - uprime * B2)
        # top (CNoise.cpp:1610-1618)
        ut = mu_adj * c
        gmu_t = c * nu_.grad_ln_cum_gaussian(ut)
        gvs_t = -0.5 * gmu_t * c * ut
        gmu = torch.where(t == 0, gmu_0, torch.where(t == C - 1, gmu_t, gmu_m))
        gvs = torch.where(t == 0, gvs_0, torch.where(t == C - 1, gvs_t, gvs_m))
        nanmask = torch.isnan(y)
        return torch.where(nanmask, 0.0, gmu), torch.where(nanmask, 0.0, gvs)

    def out(self, p, mu, varsigma):
        """Category prediction: the bin the adjusted mean falls in
        (COrderedNoise::out)."""
        bias, widths = self._split(p)
        mu_adj = mu + bias[None, :]
        edges = torch.cat([torch.zeros(1, dtype=p.dtype, device=p.device),
                           torch.cumsum(widths, dim=0)])
        below = torch.sum(mu_adj[..., None] > edges[None, None, :], dim=-1)
        return below.to(mu.dtype)


_TYPES = {"gaussian": GaussianNoise, "scale": ScaleNoise, "probit": ProbitNoise,
          "ncnm": NcnmNoise, "ordered": OrderedNoise}


def make_noise(kind: str, output_dim: int, **kwargs) -> Noise:
    if kind not in _TYPES:
        raise ValueError(f"Unknown noise model {kind}")
    return _TYPES[kind](output_dim=output_dim, **kwargs)
