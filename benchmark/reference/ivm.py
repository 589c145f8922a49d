"""Plain reference of the Informative Vector Machine (Lawrence, Seeger &
Herbrich, "Fast Sparse Gaussian Process Methods: The Informative Vector
Machine", NIPS 2003; GPc's CIvm.cpp) with Gaussian noise and the kernel
cmpnd(rbf, bias, white): greedy entropy selection by assumed-density
filtering (ADF), the state after a given order, the active-set negative log
likelihood over the kernel parameters and the Gaussian noise model's over
its parameters, each with its gradient in closed form.  Plain PyTorch in
float64, on the device it is given; it takes X, y and the parameters and
works out everything else again.

Parameters: the kernel's x = (γ, σ², b, w), the rbf inverse width and
variance and the bias and white variances, and the noise's (bias_1..D,
σ_n²).  The optimisers' unconstrained vectors are a = log x for the kernel
and (bias, log σ_n²) for the noise; the exp transform clamps its argument
to ±36 (reference/gp.py's LIMVAL) and passes no gradient beyond.

With Gaussian noise ADF is exact.  Point i's site has precision
β̃ = 1/σ_n² and mean m̃ = y_i − bias.  ν and g take CNoise::getNuG's
general form, g = ∂log Z/∂μ = (y − bias − μ)/(σ_n² + ς) and
ν = g² − 2·∂log Z/∂ς, with ∂log Z/∂ς = ½·(g² − 1/(σ_n² + ς)) (equal to
1/(σ_n² + ς); |ν| < 1e-6 becomes the float64 epsilon), the first output's ν
standing for all D outputs (spherical noise).  From μ = 0 and ς = diag K,
each step adds the inactive point of largest entropy reduction
Δ_i = −½·D·log(1 − ς_i·ν_i + 1e-300) (CIvm's; the first such point at a
tie), and then, with s = K[:, i] − MᵀM[:, i] the column of the current
posterior covariance,

    M ← [M; √ν_i·sᵀ]      L ← [L 0; M[:, i]ᵀ 1/√ν_i]
    ς ← ς − ν_i·s²        μ ← μ + g_i·s

The active-set likelihood is CIvm::logLikelihood's, on A = K_AA + diag(1/β̃):
nll = ½·(D·log|A| + Σ_j m̃_jᵀA⁻¹m̃_j), with ∂nll/∂θ = ½·tr(W·∂K/∂θ),
W = D·A⁻¹ − Σ_j α_jα_jᵀ, α = A⁻¹m̃.  The noise model's is
½·Σ_ij [log(ς_i + σ_n²) + (y_ij − μ_ij − bias_j)²/(ς_i + σ_n²)] + ½·N·D·log 2π.

Departures from the paper and CIvm.cpp, each an equal form or a narrowing:
  * the picked point's own ς becomes ς_i/(1 + ς_i·β̃), its equal (s_i = ς_i),
    in place of ς_i − ν_i·s_i², which cancels to σ_n²'s size;
  * Gaussian noise only, one site precision for all outputs (spherical);
  * no parameter priors (`-k rbf` has none) and no jitter: a Cholesky
    factor that fails is NaN throughout.

`precision="control"` is the precision control of reference/gp.py: float32
with every matrix product on TF32-rounded operands, one step below the
configuration's float32 without TF32."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from harness.spec import module

_gp = module(Path(__file__).resolve().parents[2], "reference", "gp")
LIMVAL = _gp.LIMVAL
EPS = float(np.finfo(np.float64).eps)
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def kern_leaves(cfg: dict) -> list[tuple[str, slice]]:
    """The kernel parameters, each compared as one leaf."""
    return [(n, slice(i, i + 1)) for i, n in
            enumerate(("rbf.inverseWidth", "rbf.variance", "bias.variance", "white.variance"))]


def noise_leaves(cfg: dict) -> list[tuple[str, slice]]:
    d = cfg["D"]
    return [("bias", slice(0, d)), ("sigma2", slice(d, d + 1))]


def kern_a(kern_params) -> np.ndarray:
    """The kernel's unconstrained vector: log x."""
    return np.log(np.asarray(kern_params, dtype=np.float64))


def noise_a(noise_params) -> np.ndarray:
    """The noise's unconstrained vector: the biases and log σ_n²."""
    p = np.array(noise_params, dtype=np.float64)
    p[-1] = math.log(p[-1])
    return p


def _t(x, P, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=P.dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=P.dtype, device=device)


def _exp(a):
    """(exp of the clamped a, the mask where a's gradient passes)."""
    return _gp._exp(a), (a >= -LIMVAL) & (a <= LIMVAL)


class _Adf:
    """The ADF state of one selection, in the precision's dtype."""

    def __init__(self, cfg, X, y, kern_params, noise_params, device, precision):
        P = self.P = _gp.Precision(cfg, precision)
        self.X, self.y = _t(X, P, device), _t(y, P, device)
        self.gamma, self.s2, self.b, self.w = _t(kern_params, P, device)
        npar = _t(noise_params, P, device)
        self.bias, self.sn2 = npar[:-1], npar[-1]
        n, d = self.X.shape[0], int(cfg["d"])
        self.mu = torch.zeros_like(self.y)
        self.vs = torch.full((n,), float(self.s2 + self.b + self.w), dtype=P.dtype, device=device)
        self.M = torch.zeros((d, n), dtype=P.dtype, device=device)
        self.L = torch.zeros((d, d), dtype=P.dtype, device=device)
        self.mask = torch.zeros(n, dtype=torch.bool, device=device)
        self.order = []
        self.m_site = torch.zeros((d, self.y.shape[1]), dtype=P.dtype, device=device)
        self.beta_site = torch.zeros_like(self.m_site)

    def nu_g(self):
        """(ν, g), each (N, D), in CNoise::getNuG's general form."""
        nu0 = (1.0 / (self.sn2 + self.vs))[:, None]
        g = (self.y - self.mu - self.bias[None, :]) * nu0
        dvs = 0.5 * (g * g - nu0)
        nu = g * g - 2.0 * dvs
        return torch.where(torch.abs(nu) < 1e-6, EPS, nu), g

    def scores(self):
        nu, _ = self.nu_g()
        delta = -0.5 * torch.log(1.0 - self.vs * nu[:, 0] + 1e-300) * self.y.shape[1]
        return delta.masked_fill(self.mask, float("-inf"))

    def add(self, i: int):
        k, P = len(self.order), self.P
        nu, g = self.nu_g()
        nu_i, g_i, vs_i = nu[i, 0], g[i], self.vs[i]
        kcol = _gp._rbf(P, self.X, self.X[i:i + 1], self.gamma, self.s2)[:, 0] + self.b
        kcol[i] += self.w
        a = self.M[:k, i]
        s = kcol - P.mm(self.M[:k].T, a[:, None])[:, 0] if k else kcol
        self.M[k] = torch.sqrt(nu_i) * s
        self.L[k, :k] = a
        self.L[k, k] = 1.0 / torch.sqrt(nu_i)
        beta = 1.0 / self.sn2
        self.vs = self.vs - s ** 2 * nu_i
        self.vs[i] = vs_i / (1.0 + vs_i * beta)
        self.mu = self.mu + g_i[None, :] * s[:, None]
        self.m_site[k] = self.y[i] - self.bias
        self.beta_site[k] = beta
        self.mask[i] = True
        self.order.append(i)

    def state(self) -> dict:
        D = self.y.shape[1]
        return dict(active_idx=torch.as_tensor(self.order, dtype=torch.int64, device=self.X.device),
                    m_site=self.m_site, beta_site=self.beta_site, mu=self.mu,
                    varsigma=self.vs[:, None].expand(-1, D), L=self.L)


def select(cfg: dict, X, y, kern_params, noise_params, device="cpu", precision="f64"):
    """Greedy entropy selection of cfg["d"] points: (state, order)."""
    adf = _Adf(cfg, X, y, kern_params, noise_params, device, precision)
    with torch.no_grad():
        for _ in range(int(cfg["d"])):
            adf.add(int(torch.argmax(adf.scores())))
    return adf.state(), np.array(adf.order, dtype=np.int64)


def replay(cfg: dict, X, y, kern_params, noise_params, order, device="cpu", precision="f64"):
    """The state after adding `order`'s points in turn, and at each step the
    gap between the largest score and the score of the point `order` adds,
    relative to the largest: 0 where it is a largest, inf where it is no
    inactive point."""
    adf = _Adf(cfg, X, y, kern_params, noise_params, device, precision)
    n = adf.X.shape[0]
    gaps = []
    with torch.no_grad():
        for i in np.asarray(order, dtype=np.int64).tolist():
            if not 0 <= i < n or bool(adf.mask[i]):
                gaps.append(math.inf)
                break
            delta = adf.scores()
            top = float(delta.max())
            gaps.append((top - float(delta[i])) / abs(top))
            adf.add(i)
    return adf.state(), np.array(gaps)


def active_nll_and_grad(cfg: dict, X_active, m_site, beta_site, a, device="cpu",
                        precision="f64"):
    """(nll, ∇_a nll) of the active set over the kernel's unconstrained
    vector a, as float64 numpy."""
    P = _gp.Precision(cfg, precision)
    Xa, m = _t(X_active, P, device), _t(m_site, P, device)
    beta = _t(beta_site, P, device)[:, 0]
    x, live = _exp(_t(a, P, device))
    g, s2, b, w = x
    D = m.shape[1]
    d2 = _gp._sqdist(P, Xa, Xa)
    Kr = s2 * torch.exp(-0.5 * g * d2)
    A = Kr + b
    A.diagonal().add_(w + 1.0 / beta)
    L = P.chol(A)
    alpha = torch.cholesky_solve(m, L)
    nll = 0.5 * (D * 2.0 * torch.sum(torch.log(torch.diagonal(L))) + torch.sum(m * alpha))
    W = D * torch.cholesky_inverse(L) - P.mm(alpha, alpha.T)
    WKr = W * Kr
    grad = torch.stack([0.5 * torch.sum(WKr * d2) * (-0.5 * g), 0.5 * torch.sum(WKr),
                        0.5 * b * torch.sum(W), 0.5 * w * torch.trace(W)])
    grad = torch.where(live, grad, torch.zeros_like(grad))
    return float(nll), grad.cpu().numpy().astype(np.float64)


def noise_nll_and_grad(cfg: dict, y, mu, varsigma, a, device="cpu", precision="f64"):
    """(nll, ∇_a nll) of the Gaussian noise model at the moments μ, ς over
    its unconstrained vector a = (bias, log σ_n²), as float64 numpy."""
    P = _gp.Precision(cfg, precision)
    y, mu, vs = _t(y, P, device), _t(mu, P, device), _t(varsigma, P, device)
    at = _t(a, P, device)
    bias = at[:-1]
    sn2, live = _exp(at[-1])
    var = vs + sn2
    r = y - mu - bias[None, :]
    nll = 0.5 * torch.sum(torch.log(var) + r * r / var) + y.numel() * HALF_LOG_2PI
    g_bias = -torch.sum(r / var, dim=0)
    g_s = 0.5 * torch.sum(1.0 / var - r * r / (var * var)) * sn2
    grad = torch.cat([g_bias, torch.where(live, g_s, torch.zeros_like(g_s))[None]])
    return float(nll), grad.cpu().numpy().astype(np.float64)
