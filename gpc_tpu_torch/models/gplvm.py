"""GP-LVM / GPDM: the Gaussian-process latent variable model with back
constraints and Wang-style dynamics.

Counterpart of gpc_tpu/models/gplvm.py (the reference's CGplvm).  The
latent coordinates X (or back-constraint coefficients A, X = bK·A) live in
the parameter vector, kernel parameters first (CGplvm.cpp:257-330):

  [kernel][dynamics kernel, if learnt][X or A column-major][scales, if learnt]

and the objective

  L = −½ Σ_j^D [m_jᵀK⁻¹m_j + logdet K]
      −½ s·Σ_j^q [XoutᵀdynK⁻¹Xout + logdet dynK]      (dynamics; s = D/q or 1)
      −½·(latent regulariser) −Σ_j log|scale_j| + priors  (CGplvm.cpp:493-553)

is one differentiable function of θ: `torch.autograd.grad` gives dL/dX, the
back-constraint chain rule and the dynamics shift terms.  gpc_tpu's
documented quirks are kept: no −(N·D/2)·log 2π term, and with dynamics
only X[:, 0] is regularised.  Xout is X shifted up one row with the
sequence-break rows zeroed, and dynK has the break rows and columns knocked
out to the identity (CGplvm.cpp:231-243, 448-489).

The latent kernel's evidence comes from ops/evidence_mode.kern_evidence,
which runs the engine GPC_TPU_EVIDENCE selects: dense (jitchol), lazy
(K1/K4 blocks in the left-looking factorization), panel (K3) or iterative
(CG + SLQ over K1/K4 row blocks).  Under iterative the dynamics term takes the masked
matrix-free engine; under every other engine the dynamics Gram is dense
and jitchol'ed, as in gpc_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg, resolve_device
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.kernels import Kern
from gpc_tpu_torch.optim import check_gradients, numpy_value_and_grad, run_optimiser
from gpc_tpu_torch.ops.evidence_mode import kern_evidence, resolve_engine
from gpc_tpu_torch.ops.iterative import kern_evidence_iterative_masked
from gpc_tpu_torch.utils.refrng import RefRng


@dataclasses.dataclass(frozen=True)
class GplvmSpec:
    kern: Kern
    n_data: int
    data_dim: int
    latent_dim: int
    dyn_kern: Optional[Kern] = None
    dyn_kern_learnt: bool = True     # false in fixed-SNR GPDM mode (gplvm.cpp:547-548)
    back_constrained: bool = False
    learn_scales: bool = False       # isInputScaleLearnt
    latent_regularised: bool = True
    dynamic_scaling: float = 1.0     # data_dim/latent_dim when enabled (CGplvm.h:160-173)
    dyn_breaks: Tuple[int, ...] = (0,)

    @property
    def has_dynamics(self) -> bool:
        return self.dyn_kern is not None

    def n_params(self) -> int:
        n = self.kern.n_params + self.n_data * self.latent_dim
        if self.has_dynamics and self.dyn_kern_learnt:
            n += self.dyn_kern.n_params
        if self.learn_scales:
            n += self.data_dim
        return n

    def unpack(self, theta: torch.Tensor):
        """theta → (kern_p, dyn_p or None, Xvals (N, q), scales or None)."""
        i = 0
        nk = self.kern.n_params
        kp = tr.apply_atox(self.kern.transform_codes(), theta[i:i + nk])
        i += nk
        dp = None
        if self.has_dynamics and self.dyn_kern_learnt:
            nd = self.dyn_kern.n_params
            dp = tr.apply_atox(self.dyn_kern.transform_codes(), theta[i:i + nd])
            i += nd
        nx = self.n_data * self.latent_dim
        # column-major: the reference runs over dimensions outside, rows inside
        Xvals = theta[i:i + nx].reshape(self.latent_dim, self.n_data).T.contiguous()
        i += nx
        scales = theta[i:i + self.data_dim] if self.learn_scales else None
        return kp, dp, Xvals, scales

    def pack(self, kern_params, Xvals, dyn_params=None, scales=None) -> np.ndarray:
        """Constrained quantities → unconstrained theta (numpy float64)."""
        def xtoa(kern, params):
            p = torch.as_tensor(np.asarray(params, dtype=np.float64))
            return tr.apply_xtoa(kern.transform_codes(), p).numpy()

        parts = [xtoa(self.kern, kern_params)]
        if self.has_dynamics and self.dyn_kern_learnt:
            parts.append(xtoa(self.dyn_kern, dyn_params))
        parts.append(np.asarray(Xvals, dtype=np.float64).T.ravel())
        if self.learn_scales:
            parts.append(np.asarray(scales, dtype=np.float64))
        return np.concatenate(parts)

    def break_rows(self) -> np.ndarray:
        """Knocked-out row indices: N − 1 for break 0, else brk − 1
        (CGplvm.cpp:236-242, 466-477)."""
        return np.array([self.n_data - 1 if b == 0 else b - 1 for b in self.dyn_breaks],
                        dtype=np.int64)


def _latent_X(spec: GplvmSpec, Xvals, bK):
    """X = bK·A under back constraints (CGplvm::updateX, CGplvm.cpp:224-230)."""
    return bK @ Xvals if spec.back_constrained else Xvals


def _break_mask(spec: GplvmSpec, like):
    """1 everywhere, 0 at the break rows, in like's dtype and device."""
    mask = torch.ones((spec.n_data,), dtype=like.dtype, device=like.device)
    rows = torch.as_tensor(spec.break_rows(), device=like.device)
    return mask.index_fill(0, rows, 0.0)


def _xout(spec: GplvmSpec, X):
    """Up-shifted X with the break rows zeroed (CGplvm.cpp:231-243)."""
    Xout = torch.cat([X[1:], torch.zeros((1, X.shape[1]), dtype=X.dtype, device=X.device)])
    return Xout.index_fill(0, torch.as_tensor(spec.break_rows(), device=X.device), 0.0)


def _dyn_gram(spec: GplvmSpec, dp, X):
    """Dynamics Gram with the break rows and columns knocked out to the
    identity (CGplvm.cpp:448-477)."""
    dynK = spec.dyn_kern.gram(dp, X)
    keep = _break_mask(spec, dynK)
    dynK = dynK * keep[:, None] * keep[None, :]
    return torch.diagonal_scatter(dynK, dynK.diagonal() + (1.0 - keep))


def log_likelihood(spec: GplvmSpec, theta, y, noise_bias, fixed_scales,
                   dyn_params_fixed=None, bK=None):
    """CGplvm::logLikelihood (CGplvm.cpp:493-553), differentiable in theta;
    every tensor on one device in its working dtype."""
    kp, dp, Xvals, scales = spec.unpack(theta)
    if dp is None and spec.has_dynamics:
        dp = dyn_params_fixed
    scales = scales if spec.learn_scales else fixed_scales
    X = _latent_X(spec, Xvals, bK)
    m = (y - noise_bias[None, :]) / scales[None, :]
    N, D, q = spec.n_data, spec.data_dim, spec.latent_dim

    engine = resolve_engine(spec.kern, N)
    logdet, quad = kern_evidence(spec.kern, kp, X, m, engine)
    Lacc = quad + D * logdet

    if spec.has_dynamics:
        Xout = _xout(spec, X)
        s = spec.dynamic_scaling
        if engine == "iterative":
            # the knocked-out dynamics Gram as mask·dynK·mask + (I − mask):
            # break rows have eigenvalue 1 and Xout is zero there
            ld_d, quad_d = kern_evidence_iterative_masked(
                spec.dyn_kern, dp, X, Xout, _break_mask(spec, X))
        else:
            ld_d, quad_d, _L = linalg.evidence_terms(_dyn_gram(spec, dp, X), Xout)
        Lacc = Lacc + s * (quad_d + q * ld_d)
        if spec.latent_regularised:
            # the reference regularises norm2Col(0) here (CGplvm.cpp:530-534)
            Lacc = Lacc + torch.sum(X[:, 0] ** 2)
    elif spec.latent_regularised:
        Lacc = Lacc + torch.sum(X * X)

    if spec.learn_scales:
        Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
    L = -0.5 * Lacc
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    if spec.has_dynamics and spec.dyn_kern_learnt:
        L = L + priors_mod.total_log_prob(spec.dyn_kern.priors_global, dp)
    # no −(N·D/2)·log 2π: CGplvm::logLikelihood omits it (gpc_tpu keeps the quirk)
    return L


def pca_init(m, latent_dim):
    """PCA initialization X = m·U·Λ^(−1/2), mean-centred (CGplvm.cpp:157-188);
    numpy float64 on the host."""
    m = np.asarray(m)
    N = m.shape[0]
    cov = m.T @ m / N - np.outer(m.mean(0), m.mean(0))
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(vals)[::-1][:latent_dim]
    W = vecs[:, order] / np.sqrt(vals[order])[None, :]
    X = m @ W
    return X - X.mean(0)


def back_constraint_init(bK, latent_dim):
    """X = top eigenvectors of bK; A solves bK·A = X (CGplvm.cpp:189-222);
    numpy float64 on the host."""
    vals, vecs = np.linalg.eigh(np.asarray(bK))
    order = np.argsort(vals)[::-1][:latent_dim]
    X = vecs[:, order]
    A = np.linalg.solve(np.asarray(bK), X)
    return X, A


def posterior(spec: GplvmSpec, theta, y, noise_bias, fixed_scales, Xtest,
              dyn_params_fixed=None, bK=None):
    """Latent → data posterior (CGplvm::posteriorMeanVar, CGplvm.cpp:340-361),
    in the scaled m-space as the reference's (rescaling is the noise
    model's job)."""
    kp, _dp, Xvals, scales = spec.unpack(theta)
    scales = scales if spec.learn_scales else fixed_scales
    X = _latent_X(spec, Xvals, bK)
    m = (y - noise_bias[None, :]) / scales[None, :]
    L_K, _ = linalg.jitchol(spec.kern.gram(kp, X))
    kX = spec.kern.compute(kp, X, Xtest)
    v = linalg.tri_solve(L_K, kX)
    var = torch.clamp(spec.kern.diag(kp, Xtest) - torch.sum(v * v, dim=0), min=0.0)
    # K⁻¹kX = L⁻ᵀv reuses the variance solve
    mu = linalg.tri_solve(L_K, v, trans=True).T @ m
    return mu, var[:, None].expand(-1, spec.data_dim)


class GPLVM:
    """CGplvm-equivalent model: the data, the preprocessing and the current
    parameter vector.

    y, noise_bias, fixed_scales, theta and bK are float64 numpy arrays, as in
    gpc_tpu; the data move to `device` once, in its working dtype (float32 on
    CUDA, float64 on the CPU).  `device=None` means the card and raises when
    there is none.  init="pca" (the default), "rand" (the reference's
    variance-0.001 MT19937 normals, column-major) or, under back
    constraints, the top eigenvectors of bK."""

    def __init__(self, kern: Kern, y, latent_dim: int = 2,
                 dyn_kern: Optional[Kern] = None, dyn_kern_params=None,
                 dyn_kern_learnt: bool = True, back_kernel_matrix=None,
                 centre: bool = True, scale_data: bool = False,
                 learn_scales: bool = False, latent_regularised: bool = True,
                 dynamic_scaling: bool = False, dyn_breaks=(0,),
                 init: str = "pca", seed: Optional[int] = None, device=None):
        y = np.asarray(y, dtype=np.float64)
        self.y = y
        N, D = y.shape
        scaling = (D / latent_dim) if dynamic_scaling else 1.0
        self.spec = GplvmSpec(
            kern=kern, n_data=N, data_dim=D, latent_dim=latent_dim,
            dyn_kern=dyn_kern, dyn_kern_learnt=dyn_kern_learnt,
            back_constrained=back_kernel_matrix is not None,
            learn_scales=learn_scales, latent_regularised=latent_regularised,
            dynamic_scaling=scaling, dyn_breaks=tuple(dyn_breaks))
        # CScaleNoise-style preprocessing (gplvm.cpp:506-519)
        self.noise_bias = y.mean(0) if centre else np.zeros(D)
        self.fixed_scales = (np.maximum(y.std(0, ddof=1), np.finfo(float).eps)
                             if scale_data else np.ones(D))
        self.bK = (np.asarray(back_kernel_matrix, dtype=np.float64)
                   if back_kernel_matrix is not None else None)
        self.dyn_params_fixed = (np.asarray(dyn_kern_params, dtype=np.float64)
                                 if dyn_kern_params is not None else
                                 (dyn_kern.default_params() if dyn_kern is not None else None))
        self.device = resolve_device(device)
        self.yd = as_tensor(y, self.device)
        self.bKd = as_tensor(self.bK, self.device) if self.bK is not None else None

        m = (y - self.noise_bias) / self.fixed_scales
        if init == "rand":
            # CGplvm::initXrand: variance-0.001 normals in column-major order
            # from the reference's MT19937 stream (CGplvm.cpp:144-149)
            rng = RefRng(seed if seed is not None else 0)
            Xvals = np.array([rng.randn() for _ in range(N * latent_dim)],
                             dtype=np.float64).reshape(latent_dim, N).T * np.sqrt(0.001)
        elif self.spec.back_constrained:
            _, Xvals = back_constraint_init(self.bK, latent_dim)
        else:
            Xvals = pca_init(m, latent_dim)
        self.theta = self.spec.pack(
            kern.default_params(), Xvals,
            dyn_params=self.dyn_params_fixed if (dyn_kern is not None and dyn_kern_learnt)
            else None,
            scales=self.fixed_scales if learn_scales else None)

    def objective(self):
        """nlml(θ tensor) = −logLikelihood over the data on the device."""
        spec, dev = self.spec, self.device
        y, bias = self.yd, as_tensor(self.noise_bias, dev)
        fs = as_tensor(self.fixed_scales, dev)
        dpf = as_tensor(self.dyn_params_fixed, dev) if self.dyn_params_fixed is not None else None
        bK = self.bKd

        def nlml(theta):
            return -log_likelihood(spec, theta, y, bias, fs, dyn_params_fixed=dpf, bK=bK)
        return nlml

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(self.objective()(as_tensor(self.theta, self.device)))

    def value_and_grad_fn(self):
        """w (float64 numpy) → (nlml, ∇nlml) as float64, computed on the
        model's device in its working dtype."""
        return numpy_value_and_grad(self.objective(), self.device)

    def optimise(self, iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, optimiser: str = "scg",
                 verbose: int = 0, ckpt_path: str = None,
                 ckpt_every: int = 50, resume: bool = False):
        """SCG by default, or conjgrad / graddesc / quasinew; at verbose > 2
        with fewer than 40 parameters a finite-difference gradient check
        runs first (CGp.cpp:1544-1545).  ckpt_path writes SCG checkpoints
        every `ckpt_every` iterations; resume=True continues a killed run."""
        vag = self.value_and_grad_fn()
        if verbose > 2 and self.theta.size < 40:
            check_gradients(vag, self.theta)
        res = run_optimiser(optimiser, vag, self.theta, iters,
                            param_tol=param_tol, obj_tol=obj_tol,
                            ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                            resume=resume)
        self.theta = np.asarray(res.x, dtype=np.float64)
        return res

    # -- accessors (host, float64) ------------------------------------------
    def _unpacked(self):
        return self.spec.unpack(torch.as_tensor(self.theta))

    def kern_params(self) -> np.ndarray:
        return self._unpacked()[0].numpy()

    def dyn_kern_params(self):
        dp = self._unpacked()[1]
        return dp.numpy() if dp is not None else self.dyn_params_fixed

    def latent_X(self) -> np.ndarray:
        Xvals = self._unpacked()[2].numpy()
        return self.bK @ Xvals if self.spec.back_constrained else Xvals

    def scales(self) -> np.ndarray:
        s = self._unpacked()[3]
        return s.numpy() if s is not None else self.fixed_scales

    def predict_from_latent(self, Xtest):
        """(mu, var) in y-space as numpy arrays, each (T, D)."""
        dev = self.device
        with torch.no_grad():
            mu, var = posterior(self.spec, as_tensor(self.theta, dev), self.yd,
                                as_tensor(self.noise_bias, dev),
                                as_tensor(self.fixed_scales, dev),
                                as_tensor(np.asarray(Xtest, dtype=np.float64), dev),
                                bK=self.bKd)
        mu, var = mu.cpu().numpy(), var.cpu().numpy()
        # rescale to y-space through the scale noise (CScaleNoise::out)
        s = self.scales()
        return mu * s[None, :] + self.noise_bias[None, :], var * (s ** 2)[None, :]

    def display(self):
        lines = ["GPLVM Model:",
                 f"  Data dimension: {self.spec.data_dim}",
                 f"  Latent dimension: {self.spec.latent_dim}",
                 f"  Number of data: {self.spec.n_data}",
                 f"  Back constrained: {self.spec.back_constrained}",
                 f"  Dynamics: {self.spec.has_dynamics}"]
        for name, val in zip(self.spec.kern.display_names(), self.kern_params()):
            lines.append(f"  {name}: {val}")
        if self.spec.has_dynamics:
            for name, val in zip(self.spec.dyn_kern.display_names(), self.dyn_kern_params()):
                lines.append(f"  dyn {name}: {val}")
        return "\n".join(lines)
