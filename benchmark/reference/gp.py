"""Plain reference of GP regression with cmpnd(rbf, bias, white): the FTC
and DTC negative log likelihood with its gradient in θ, and their
posterior mean and variance.  Plain PyTorch in float64, written from the
textbook forms (Rasmussen & Williams 2006, eq. 2.30 and 5.9; Quiñonero-
Candela & Rasmussen 2005, DTC), on the device it is given.  It takes the
generated X, y, θ and test inputs and works out everything else again.

θ is the unconstrained vector of `gp learn`: for DTC the inducing inputs
X_u column-major (M·q), then log of [inverse width γ, rbf variance σ²,
bias b, white w], then for DTC log β; the data are centred (y − ȳ).

`precision="control"` is the precision control: one step below what the
configuration states.  Every matrix product takes operands rounded to
TF32 (10 mantissa bits, the step below float32 without TF32) and runs in
float32; for a configuration that holds its Cholesky factor in bfloat16
(precision `factor: bf16`), the factor is held in float8 e4m3 (the step below
bfloat16)."""

from __future__ import annotations

import math

import numpy as np
import torch

LIMVAL = 36.0       # the exp transform's clamp of its argument
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """The arithmetic of one evaluation: float64, or the control's."""

    def __init__(self, cfg: dict, precision: str):
        if precision not in ("f64", "control"):
            raise ValueError(f"precision {precision!r}")
        self.control = precision == "control"
        self.dtype = torch.float32 if self.control else torch.float64
        self.fp8_factor = self.control and cfg["precision"]["factor"] == "bf16"

    def mm(self, a, b):
        return tf32(a) @ tf32(b) if self.control else a @ b

    def chol(self, A, factor=False):
        """The lower Cholesky factor; NaN throughout where A is not
        positive definite at this precision."""
        L, info = torch.linalg.cholesky_ex(A)
        if int(info) != 0:
            L = torch.full_like(A, float("nan"))
        if factor and self.fp8_factor:
            L = L.to(torch.float8_e4m3fn).to(torch.float32)
        return L


def leaves(cfg: dict) -> list[tuple[str, slice]]:
    """θ's parameter groups, each compared as one leaf."""
    i = cfg["M"] * cfg["q"] if cfg["approx"] != "ftc" else 0
    out = [("X_u", slice(0, i))] if i else []
    for name in ("rbf.inverseWidth", "rbf.variance", "bias.variance", "white.variance"):
        out.append((name, slice(i, i + 1)))
        i += 1
    if cfg["approx"] != "ftc":
        out.append(("beta", slice(i, i + 1)))
    return out


def _exp(a):
    return torch.exp(torch.clamp(a, -LIMVAL, LIMVAL))


def _unpack(cfg, theta):
    """(X_u or None, γ, σ², b, w, β or None) from θ."""
    if cfg["approx"] == "ftc":
        g, s2, b, w = _exp(theta[:4])
        return None, g, s2, b, w, None
    m, q = cfg["M"], cfg["q"]
    Xu = theta[:m * q].reshape(q, m).T
    g, s2, b, w = _exp(theta[m * q:m * q + 4])
    return Xu, g, s2, b, w, _exp(theta[m * q + 4])


def _sqdist(P, X1, X2):
    n1 = torch.sum(X1 * X1, dim=1)
    n2 = torch.sum(X2 * X2, dim=1)
    return torch.clamp(n1[:, None] + n2[None, :] - 2.0 * P.mm(X1, X2.T), min=0.0)


def _rbf(P, X1, X2, g, s2):
    return s2 * torch.exp(-0.5 * g * _sqdist(P, X1, X2))


def _tensors(cfg, X, y, theta, device, P):
    X = torch.as_tensor(np.asarray(X), dtype=P.dtype, device=device)
    y = torch.as_tensor(np.asarray(y), dtype=P.dtype, device=device)
    th = torch.as_tensor(np.asarray(theta), dtype=P.dtype, device=device)
    return X, y - y.mean(dim=0, keepdim=True), th


def nlml_and_grad(cfg: dict, X, y, theta, device="cpu", precision="f64"):
    """(−log p(y | X, θ), its gradient in θ) as float64 numpy."""
    P = Precision(cfg, precision)
    X, m, th = _tensors(cfg, X, y, theta, device, P)
    if cfg["approx"] == "ftc":
        return _ftc(P, X, m, th)
    if cfg["approx"] == "dtc":
        th.requires_grad_(True)
        f = _dtc_nlml(cfg, P, X, m, th)
        (g,) = torch.autograd.grad(f, th)
        return float(f.detach()), g.detach().cpu().numpy().astype(np.float64)
    raise ValueError(f"reference: approximation {cfg['approx']!r}")


def _ftc(P, X, m, th):
    """FTC with the gradient in closed form: ∂nlml/∂θⱼ = ½ tr(W ∂K/∂θⱼ),
    W = D·K⁻¹ − αα^T, α = K⁻¹m; each ∂K/∂θⱼ through the exp transform."""
    n, d = m.shape
    _, g, s2, b, w, _ = _unpack({"approx": "ftc"}, th)
    d2 = _sqdist(P, X, X)
    Kr = s2 * torch.exp(-0.5 * g * d2)
    K = Kr + b
    K.diagonal().add_(w)
    L = P.chol(K, factor=True)
    del K
    alpha = torch.cholesky_solve(m, L)
    nlml = (0.5 * torch.sum(m * alpha) + d * torch.sum(torch.log(torch.diagonal(L)))
            + n * d * HALF_LOG_2PI)
    W = torch.cholesky_inverse(L)
    del L
    W.mul_(d)
    W.sub_(P.mm(alpha, alpha.T))
    WKr = W * Kr
    grad = torch.stack([0.5 * torch.sum(WKr * d2) * (-0.5 * g), 0.5 * torch.sum(WKr),
                        0.5 * b * torch.sum(W), 0.5 * w * torch.trace(W)])
    return float(nlml), grad.cpu().numpy().astype(np.float64)


def _dtc_parts(cfg, P, X, m, th):
    Xu, g, s2, b, w, beta = _unpack(cfg, th)
    Kuu = _rbf(P, Xu, Xu, g, s2) + b + w * torch.eye(Xu.shape[0], dtype=P.dtype,
                                                      device=X.device)
    Kuf = _rbf(P, Xu, X, g, s2) + b
    A = Kuu + beta * P.mm(Kuf, Kuf.T)
    return Xu, (g, s2, b, w, beta), Kuu, Kuf, A


def _dtc_nlml(cfg, P, X, m, th):
    """DTC: y ~ N(0, Q + β⁻¹I), Q = K_fu K_uu⁻¹ K_uf, by the determinant
    lemma and Woodbury's identity through A = K_uu + β K_uf K_fu."""
    n, d = m.shape
    _, (_, _, _, _, beta), Kuu, Kuf, A = _dtc_parts(cfg, P, X, m, th)
    Lu = P.chol(Kuu)
    La = P.chol(A)
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(La)))
              - 2.0 * torch.sum(torch.log(torch.diagonal(Lu))) - n * torch.log(beta))
    c = torch.linalg.solve_triangular(La, P.mm(Kuf, m), upper=False)
    quad = beta * torch.sum(m * m) - beta * beta * torch.sum(c * c)
    return 0.5 * (d * logdet + quad) + n * d * HALF_LOG_2PI


def posterior_state(cfg: dict, X, y, theta, device="cpu", precision="f64") -> dict:
    """Everything a batch of predictions shares, factored once."""
    P = Precision(cfg, precision)
    X, m, th = _tensors(cfg, X, y, theta, device, P)
    ybar = torch.as_tensor(np.asarray(y), dtype=P.dtype, device=device).mean(dim=0)
    if cfg["approx"] == "ftc":
        _, g, s2, b, w, _ = _unpack(cfg, th)
        K = _rbf(P, X, X, g, s2) + b
        K.diagonal().add_(w)
        L = P.chol(K)
        del K
        alpha = torch.cholesky_solve(m, L)
        Linv = None
        if P.control:   # the program's explicit-inverse product, in TF32
            Linv = torch.linalg.solve_triangular(
                L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device), upper=False)
        return dict(P=P, approx="ftc", X=X, hyp=(g, s2, b, w), L=L, Linv=Linv,
                    alpha=alpha, ybar=ybar)
    if cfg["approx"] == "dtc":
        Xu, hyp, Kuu, Kuf, A = _dtc_parts(cfg, P, X, m, th)
        La = P.chol(A)
        c = torch.linalg.solve_triangular(La, P.mm(Kuf, m), upper=False)
        return dict(P=P, approx="dtc", Xu=Xu, hyp=hyp, Lu=P.chol(Kuu), La=La, c=c, ybar=ybar)
    raise ValueError(f"reference: approximation {cfg['approx']!r}")


def posterior(st: dict, Xt) -> tuple[np.ndarray, np.ndarray]:
    """Predictive (mean, variance of y*), each (T, D) float64 numpy."""
    P = st["P"]
    dev = st["ybar"].device
    Xt = torch.as_tensor(np.asarray(Xt), dtype=P.dtype, device=dev)
    if st["approx"] == "ftc":
        g, s2, b, w = st["hyp"]
        Ks = _rbf(P, st["X"], Xt, g, s2) + b                      # (N, T)
        mu = P.mm(Ks.T, st["alpha"]) + st["ybar"]
        if st["Linv"] is not None:
            v = P.mm(st["Linv"], Ks)
        else:
            v = torch.linalg.solve_triangular(st["L"], Ks, upper=False)
        var = (s2 + b + w) - torch.sum(v * v, dim=0)
    else:
        g, s2, b, w, beta = st["hyp"]
        Ks = _rbf(P, st["Xu"], Xt, g, s2) + b                     # (M, T)
        w1 = torch.linalg.solve_triangular(st["Lu"], Ks, upper=False)
        wa = torch.linalg.solve_triangular(st["La"], Ks, upper=False)
        mu = beta * P.mm(wa.T, st["c"]) + st["ybar"]
        var = (s2 + b + w) - torch.sum(w1 * w1, dim=0) + torch.sum(wa * wa, dim=0) + 1.0 / beta
    var = var[:, None].expand_as(mu)
    return (mu.cpu().numpy().astype(np.float64), var.cpu().numpy().astype(np.float64))
