"""Full and sparse Gaussian-process regression (FTC / DTC / DTCVAR / FITC /
PITC): evidence and posterior.

Counterpart of gpc_tpu/models/gp.py.  Parameter layout (CGp::getOptParams,
CGp.cpp:330-385), the same unconstrained theta as gpc_tpu's:
  [X_u column-major (sparse, inducing inputs learned)]
  [kernel transformed params]
  [output scales (learn_scales; linear)]
  [log β (sparse)]

`log_likelihood` takes the FTC evidence from ops/evidence_mode.kern_evidence,
which runs the engine GPC_TPU_EVIDENCE selects: `dense` (jitchol), `lazy`
(the left-looking blocked factorization with Gram blocks from K1/K4),
`panel` (the K3 kernel) or `iterative` (matrix-free CG + SLQ over K1/K4
row blocks, ops/iterative.py).  The sparse forms are gpc_tpu's (CGp.cpp:913-1014):
every one factors A = (1/β)·K_uu + K_uf·D⁻¹·K_fu through the L_uu-whitened
Am = I/β + Ṽ·Ṽᵀ, and their Grams (K_uu, K_uf, each serving batch's K_u*,
PITC's block Grams in one batched launch) run on K1/K4 on the card.  All
differentiate in θ, X_u and β: `GP.optimise` trains on the gradient that
`torch.autograd.grad` takes through them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg, ndlutil, resolve_device
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.kernels import Kern
from gpc_tpu_torch.optim import check_gradients, numpy_value_and_grad, run_optimiser
from gpc_tpu_torch.ops.evidence_mode import kern_evidence
from gpc_tpu_torch.utils.profiling import COUNTS
from gpc_tpu_torch.utils.refrng import RefRng

FTC, DTC, DTCVAR, FITC, PITC = "ftc", "dtc", "dtcvar", "fitc", "pitc"
_SPARSE = (DTC, DTCVAR, FITC, PITC)


@dataclasses.dataclass(frozen=True)
class GpSpec:
    """Static model description."""

    kern: Kern
    n_data: int
    input_dim: int
    output_dim: int
    approx: str = FTC
    num_active: int = 0
    learn_scales: bool = False      # isOutputScaleLearnt
    inducing_fixed: bool = False
    pitc_block: int = 0             # PITC's block size; 0 → num_active

    @property
    def sparse(self) -> bool:
        return self.approx in _SPARSE

    @property
    def block_size(self) -> int:
        return self.pitc_block if self.pitc_block > 0 else max(self.num_active, 1)

    def n_params(self) -> int:
        n = self.kern.n_params
        if self.sparse and not self.inducing_fixed:
            n += self.num_active * self.input_dim
        if self.learn_scales:
            n += self.output_dim
        return n + (1 if self.sparse else 0)

    def unpack(self, theta: torch.Tensor):
        """theta (unconstrained) → (X_u or None, kern_params_constrained,
        scales or None, β or None)."""
        i = 0
        X_u = None
        if self.sparse and not self.inducing_fixed:
            m = self.num_active * self.input_dim
            # column-major: the reference runs over dimensions outside and
            # rows inside
            X_u = theta[i:i + m].reshape(self.input_dim, self.num_active).T.contiguous()
            i += m
        nk = self.kern.n_params
        kp = tr.apply_atox(self.kern.transform_codes(), theta[i:i + nk])
        i += nk
        scales = None
        if self.learn_scales:
            scales = theta[i:i + self.output_dim]
            i += self.output_dim
        beta = tr.atox(tr.EXP, theta[i]) if self.sparse else None
        return X_u, kp, scales, beta

    def pack(self, kern_params, X_u=None, scales=None, beta=None) -> np.ndarray:
        """Constrained quantities → unconstrained theta (numpy float64)."""
        parts = []
        if self.sparse and not self.inducing_fixed:
            parts.append(np.asarray(X_u, dtype=np.float64).T.ravel())   # column-major
        kp = torch.as_tensor(np.asarray(kern_params, dtype=np.float64))
        parts.append(tr.apply_xtoa(self.kern.transform_codes(), kp).numpy())
        if self.learn_scales:
            parts.append(np.asarray(scales, dtype=np.float64))
        if self.sparse:
            parts.append(np.array([math.log(float(beta))]))
        return np.concatenate(parts)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _pitc_whitened(spec: GpSpec, kp, beta, X, m, K_uf, L_uu):
    """PITC's block assembly, shared by the evidence and serving: the
    correction D = blockdiag(I + β·(K_bb − Q_bb)) applied by batched
    Cholesky solves over the leading P axis (the block Grams in one batched
    K1/K4 launch; the ragged tail padded with zeros and its D masked to the
    identity).  Returns (Am, e, Cb, sMb): the L_uu-whitened Am = I/β + W̃·W̃ᵀ,
    its whitened right-hand side e, the block factors Cb (their
    log-diagonals sum to Σ_b logdet D_b) and sMb = C_b⁻¹m_b."""
    M, N = K_uf.shape
    Bp = spec.block_size
    P = -(-N // Bp)
    pad = P * Bp - N
    q = spec.input_dim
    Xp = torch.nn.functional.pad(X, (0, 0, 0, pad))
    Kbb = spec.kern.gram(kp, Xp.reshape(P, Bp, q))                 # (P, Bp, Bp)
    Kuf_p = torch.nn.functional.pad(K_uf, (0, pad))
    Vb = linalg.tri_solve(L_uu, Kuf_p).reshape(M, P, Bp)          # L_uu⁻¹K_uf
    Qbb = torch.einsum("mpi,mpj->pij", Vb, Vb)
    eye = _eye(Bp, Kbb)[None]
    Db = eye + beta * (Kbb - Qbb)
    valid = (torch.arange(P * Bp, device=X.device) < N).reshape(P, Bp)
    Db = torch.where(valid[:, :, None] & valid[:, None, :], Db, eye)
    # gpc_tpu's batched Cholesky gives NaN for a block that is not PD
    L, info = torch.linalg.cholesky_ex(Db)
    Cb = torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)
    m_p = torch.nn.functional.pad(m, (0, 0, 0, pad)).reshape(P, Bp, m.shape[1])
    sMb = torch.linalg.solve_triangular(Cb, m_p, upper=False)     # C_b⁻¹ m_b
    Wb = torch.linalg.solve_triangular(Cb, Vb.permute(1, 2, 0), upper=False)   # (P, Bp, M)
    Am = _eye(M, Wb) / beta + torch.einsum("pbm,pbn->mn", Wb, Wb)
    e = torch.einsum("pbm,pbd->md", Wb, sMb)
    return Am, e, Cb, sMb


def _sparse_lacc(spec: GpSpec, kp, beta, X, X_u, m):
    """The sparse forms' Lacc (−2·logLikelihood before the scales, priors
    and −D·N/2·log 2π), CGp.cpp:913-1014 in gpc_tpu's whitened forms."""
    N, D = spec.n_data, spec.output_dim
    M = spec.num_active
    K_uu = spec.kern.gram(kp, X_u)
    K_uf = spec.kern.compute(kp, X_u, X)
    L_uu, _ = linalg.jitchol(K_uu)
    logb = torch.log(beta)
    if spec.approx in (DTC, DTCVAR):
        # A = (1/β)·K_uu + K_uf·K_fu (updateAD, CGp.cpp:770-773) factored
        # through A = L_uu·Am·L_uuᵀ, Am = I/β + V·Vᵀ, V = L_uu⁻¹K_uf: the same
        # quantity at cond(Am) ≪ cond(A) (gpc_tpu/models/gp.py:202-210: the
        # direct factor loses ~3 digits of gradient at β = 1e3)
        V = linalg.tri_solve(L_uu, K_uf)
        Am = _eye(M, V) / beta + V @ V.T
        L_m, _ = linalg.jitchol(Am)
        quad = torch.sum(torch.square(linalg.tri_solve(L_m, V @ m)))
        Lacc = D * ((M - N) * logb + linalg.chol_logdet(L_m))
        Lacc = Lacc - beta * (quad - torch.sum(m * m))
        if spec.approx == DTCVAR:
            diagD = beta * (spec.kern.diag(kp, X) - torch.sum(V * V, dim=0))
            Lacc = Lacc + D * torch.sum(diagD)
        return Lacc
    if spec.approx == PITC:
        # stubbed in the reference (CGp.cpp:862-871 throws), so no quirk to
        # keep: no extra N·log 2π, unlike FITC
        Am, e, Cb, sMb = _pitc_whitened(spec, kp, beta, X, m, K_uf, L_uu)
        L_m, _ = linalg.jitchol(Am)
        bet = linalg.tri_solve(L_m, e)
        Lacc = (M - N) * logb
        Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.diagonal(Cb, dim1=1, dim2=2)))
        Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.diagonal(L_m)))
        Lacc = Lacc * D
        return Lacc + beta * (torch.sum(sMb * sMb) - torch.sum(bet * bet))
    # FITC (CGp.cpp:806-858, 962-988); one M×N solve gives diag Q and V
    W = linalg.tri_solve(L_uu, K_uf)
    diagD = 1.0 + beta * (spec.kern.diag(kp, X) - torch.sum(W * W, dim=0))
    sDinv = torch.sqrt(1.0 / diagD)
    scaledM = m * sDinv[:, None]
    V = W * sDinv[None, :]
    Am = _eye(M, V) / beta + V @ V.T
    L_m, _ = linalg.jitchol(Am)
    bet = linalg.tri_solve(L_m, V) @ scaledM
    # the reference's extra N·log 2π (CGp.cpp:962-988)
    Lacc = (M - N) * logb + N * ndlutil.LOGTWOPI
    Lacc = Lacc + torch.sum(torch.log(diagD))
    Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.diagonal(L_m)))
    Lacc = Lacc * D
    return Lacc + beta * (torch.sum(scaledM * scaledM) - torch.sum(bet * bet))


def log_likelihood(spec: GpSpec, theta, X, y, bias, fixed_scales, X_u_fixed=None):
    """logLikelihood(θ) (CGp.cpp:913-1014); all tensors on one device in its
    working dtype.  X_u_fixed holds the inducing inputs when
    spec.inducing_fixed (data then, not parameters)."""
    X_u, kp, scales, beta = spec.unpack(theta)
    if X_u is None and spec.sparse:
        X_u = X_u_fixed
    scales = scales if spec.learn_scales else fixed_scales
    m = (y - bias[None, :]) / scales[None, :]
    N, D = spec.n_data, spec.output_dim
    if spec.sparse:
        Lacc = _sparse_lacc(spec, kp, beta, X, X_u, m)
    else:
        logdetK, quad = kern_evidence(spec.kern, kp, X, m)
        Lacc = quad + D * logdetK
    if spec.learn_scales:
        Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
    L = -0.5 * Lacc
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    return L - D * N * ndlutil.HALFLOGTWOPI


def make_objective(spec: GpSpec, X, y, bias, fixed_scales, X_u_fixed=None):
    """nlml(θ) = −logLikelihood(θ) over fixed data tensors."""
    def nlml(theta):
        return -log_likelihood(spec, theta, X, y, bias, fixed_scales, X_u_fixed)
    return nlml


def posterior_state(spec: GpSpec, theta, X, y, bias, fixed_scales, X_u_fixed=None,
                    explicit_inverse: bool = False):
    """Everything batch-independent of posteriorMeanVar, factored once.  FTC:
    L = chol(K), α = K⁻¹m and, with `explicit_inverse`, L⁻¹ (so each batch's
    variance solve is a product over L⁻¹'s lower triangle, a few batched
    GEMMs: `linalg.tri_apply`).  Sparse: (X_u, L_uu, L_m, u)."""
    X_u, kp, scales, beta = spec.unpack(theta)
    if X_u is None and spec.sparse:
        X_u = X_u_fixed
    scales = scales if spec.learn_scales else fixed_scales
    m = (y - bias[None, :]) / scales[None, :]
    st = dict(kp=kp, scales=scales, bias=bias, beta=beta)
    if spec.sparse:
        st.update(_sparse_posterior_state(spec, kp, X, X_u, m, beta))
        return st
    K = spec.kern.gram(kp, X)
    L, _ = linalg.jitchol(K)
    del K
    st.update(X=X, L=L, alpha=linalg.chol_solve(L, m),
              Linv=linalg.blocked_tri_inv(L) if explicit_inverse else None)
    return st


def _sparse_posterior_state(spec: GpSpec, kp, X, X_u, m, beta):
    """(X_u, L_uu, L_m, u) of the sparse family: every approximation's mean
    and variance take the same (w1, w2) form, only Am and e differ (the
    same whitened forms as the evidence)."""
    K_uu = spec.kern.gram(kp, X_u)
    K_uf = spec.kern.compute(kp, X_u, X)
    L_uu, _ = linalg.jitchol(K_uu)
    M = K_uf.shape[0]
    if spec.approx == FITC:
        V0 = linalg.tri_solve(L_uu, K_uf)
        diagD = 1.0 + beta * (spec.kern.diag(kp, X) - torch.sum(V0 * V0, dim=0))
        sDinv = torch.sqrt(1.0 / diagD)
        V = V0 * sDinv[None, :]
        Am = _eye(M, V) / beta + V @ V.T
        e = V @ (m * sDinv[:, None])
    elif spec.approx == PITC:
        # a test point forms its own block, so mean and variance take the
        # FITC form with PITC's A (Quiñonero-Candela & Rasmussen 2005, eq.
        # 24-25)
        Am, e, _Cb, _sMb = _pitc_whitened(spec, kp, beta, X, m, K_uf, L_uu)
    else:   # DTC, DTCVAR
        V = linalg.tri_solve(L_uu, K_uf)
        Am = _eye(M, V) / beta + V @ V.T
        e = V @ m
    L_m, _ = linalg.jitchol(Am)
    return dict(X_u=X_u, L_uu=L_uu, L_m=L_m, u=linalg.chol_solve(L_m, e))


def posterior_apply(spec: GpSpec, st, Xtest):
    """One batch of predictive mean and variance against a posterior_state."""
    kp, scales = st["kp"], st["scales"]
    kstar_diag = spec.kern.diag(kp, Xtest)
    if spec.sparse:
        beta = st["beta"]
        kX = spec.kern.compute(kp, st["X_u"], Xtest)          # (M, T)
        w1 = linalg.tri_solve(st["L_uu"], kX)                 # L_uu⁻¹ k_*
        mu0 = w1.T @ st["u"]
        # var = k** − k_*ᵀ(K_uu⁻¹ − A⁻¹/β)k_* + 1/β (CGp.cpp:575-605); the
        # same ≥ 0 clamp as FTC's: in f32 at a large learned β the 1/β floor
        # is below the cancellation error of k** − Σw1² near an inducing input
        w2 = linalg.tri_solve(st["L_m"], w1)
        var0 = torch.clamp(kstar_diag - torch.sum(w1 * w1, dim=0)
                           + torch.sum(w2 * w2, dim=0) / beta + 1.0 / beta, min=0.0)
    else:
        kX = spec.kern.compute(kp, st["X"], Xtest)            # (N, T)
        mu0 = kX.T @ st["alpha"]                              # (T, D)
        if st["Linv"] is not None:
            COUNTS["serve.tri_apply"] += 1
            v = linalg.tri_apply(st["Linv"], kX)
        else:
            v = linalg.tri_solve(st["L"], kX)
        # clamp at 0: near-singular K, or test points on training points, can
        # round the variance slightly negative (the f32 explicit-inverse
        # product most of all), and clients take its square root
        var0 = torch.clamp(kstar_diag - torch.sum(v * v, dim=0), min=0.0)
    mu = mu0 * scales[None, :] + st["bias"][None, :]
    var = var0[:, None] * (scales ** 2)[None, :]
    return mu, var


def posterior(spec: GpSpec, theta, X, y, bias, fixed_scales, Xtest, X_u_fixed=None):
    """Predictive (mu, varsigma), each (T, D) (posteriorMeanVar)."""
    st = posterior_state(spec, theta, X, y, bias, fixed_scales, X_u_fixed)
    return posterior_apply(spec, st, Xtest)


class GP:
    """CGp-equivalent model: data and the current parameter vector.

    X, y, bias, fixed_scales, theta and the fixed inducing inputs are float64
    numpy arrays, as in gpc_tpu; the data move to `device` once, in its
    working dtype (float32 on CUDA, float64 on the CPU).  `device=None`
    means the card, and raises when there is none: pass device="cpu" for the
    CPU.  bias = column means when centring, scale = column std when scaling
    (gp.cpp:370-410); a sparse model starts at β and takes its inducing
    inputs as the sorted seeded subset of X that gpc_tpu takes (MT19937
    randpermTrunc, CGp.cpp:273-284)."""

    def __init__(self, kern: Kern, X, y, approx: str = FTC, num_active: int = 0,
                 learn_scales: bool = False, centre: bool = True,
                 scale_data: bool = False, beta: float = 1.0,
                 seed: Optional[int] = None, inducing_fixed: bool = False,
                 pitc_block: int = 0, device=None):
        if approx not in (FTC,) + _SPARSE:
            raise ValueError(f"Unknown sparse approximation type: {approx}.")
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.X, self.y = X, y
        N, q = X.shape
        D = y.shape[1]
        self.spec = GpSpec(kern=kern, n_data=N, input_dim=q, output_dim=D,
                           approx=approx, num_active=num_active,
                           learn_scales=learn_scales, inducing_fixed=inducing_fixed,
                           pitc_block=pitc_block)
        self.bias = y.mean(axis=0) if centre else np.zeros(D)
        self.fixed_scales = y.std(axis=0, ddof=1) if scale_data else np.ones(D)
        X_u = None
        if self.spec.sparse:
            idx = np.sort(RefRng(seed if seed is not None else 0).randperm_trunc(N, num_active))
            X_u = X[idx]
        self.X_u_fixed = X_u if inducing_fixed else None
        self.theta = self.spec.pack(
            kern.default_params(), X_u=None if inducing_fixed else X_u,
            scales=self.fixed_scales if learn_scales else None,
            beta=beta if self.spec.sparse else None)
        self.device = resolve_device(device)
        self.Xd = as_tensor(X, self.device)
        self.yd = as_tensor(y, self.device)

    def _args(self):
        """(theta, X, y, bias, fixed_scales) as device tensors."""
        return (as_tensor(self.theta, self.device), self.Xd, self.yd,
                as_tensor(self.bias, self.device),
                as_tensor(self.fixed_scales, self.device))

    def _xu_fixed(self):
        """The fixed inducing inputs on the device, or None."""
        return None if self.X_u_fixed is None else as_tensor(self.X_u_fixed, self.device)

    def log_likelihood(self) -> float:
        return float(log_likelihood(self.spec, *self._args(), self._xu_fixed()))

    def value_and_grad_fn(self):
        """w (float64 numpy) → (nlml, ∇nlml) as float64, computed on the
        model's device in its working dtype (make_objective, autograd)."""
        _, X, y, bias, scales = self._args()
        return numpy_value_and_grad(
            make_objective(self.spec, X, y, bias, scales, self._xu_fixed()), self.device)

    def optimise(self, iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, optimiser: str = "scg",
                 verbose: int = 0, ckpt_path: str = None,
                 ckpt_every: int = 50, resume: bool = False):
        """SCG by default (runDefaultOptimiser, COptimisable.h:183-203);
        conjgrad / graddesc / quasinew by the reference's optimiser names
        (COptimisable.h:153-182), as gpc_tpu's GP.optimise.  At verbose > 2
        with fewer than 40 parameters a finite-difference gradient check runs
        first (CGp.cpp:1544-1545).  ckpt_path writes the SCG state every
        `ckpt_every` iterations; resume=True continues a killed run from
        that file."""
        vag = self.value_and_grad_fn()
        if verbose > 2 and self.theta.size < 40:
            check_gradients(vag, self.theta)
        res = run_optimiser(optimiser, vag, self.theta, iters,
                            param_tol=param_tol, obj_tol=obj_tol,
                            ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                            resume=resume)
        self.theta = np.asarray(res.x, dtype=np.float64)
        return res

    def predict(self, Xtest):
        """(mu, varsigma) as numpy arrays for test inputs (T, q)."""
        mu, var = posterior(self.spec, *self._args(),
                            as_tensor(np.asarray(Xtest, dtype=np.float64), self.device),
                            self._xu_fixed())
        return mu.cpu().numpy(), var.cpu().numpy()

    def _unpacked(self):
        return self.spec.unpack(torch.as_tensor(self.theta))

    def kern_params(self) -> np.ndarray:
        return self._unpacked()[1].numpy()

    def scales(self) -> np.ndarray:
        s = self._unpacked()[2]
        return s.numpy() if s is not None else self.fixed_scales

    def beta(self):
        b = self._unpacked()[3]
        return float(b) if b is not None else None

    def inducing(self):
        """The inducing inputs (M, q), fixed or learned; None for FTC."""
        if self.X_u_fixed is not None:
            return np.asarray(self.X_u_fixed)
        xu = self._unpacked()[0]
        return xu.numpy() if xu is not None else None

    def display(self):
        """Model summary (CGp::display, CGp.cpp:1583-1604)."""
        lines = ["Gaussian process model:",
                 f"  Data dimension: {self.spec.output_dim}",
                 f"  Number of data: {self.spec.n_data}",
                 f"  Approximation type: {self.spec.approx}"]
        for name, val in zip(self.spec.kern.display_names(), self.kern_params()):
            lines.append(f"  {name}: {val}")
        if self.spec.sparse:
            lines.append(f"  beta: {self.beta()}")
        return "\n".join(lines)
