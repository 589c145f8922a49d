"""Full (FTC) Gaussian-process regression: evidence and posterior.

Counterpart of gpc_tpu/models/gp.py for the FTC approximation.  Parameter
layout (CGp::getOptParams): [kernel transformed params][output scales if
learn_scales (linear)] — the same unconstrained theta as gpc_tpu's FTC.

`log_likelihood` routes the evidence through the engine that
GPC_TPU_EVIDENCE selects (ops/evidence_mode.py): `dense` (jitchol), `lazy`
(the left-looking blocked factorization with Gram blocks from K1/K4) or
`panel` (the K3 kernel).  All differentiate in θ: `GP.optimise` trains by
SCG on the gradient that `torch.autograd.grad` takes through them.  The
sparse approximations are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg, ndlutil, resolve_device
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.kernels import Kern
from gpc_tpu_torch.optim import check_gradients, run_optimiser
from gpc_tpu_torch.ops.evidence_mode import select_evidence_mode
from gpc_tpu_torch.ops.lazy_evidence import kern_evidence_lazy
from gpc_tpu_torch.ops.panel_engine import kern_evidence_panel

FTC = "ftc"


@dataclasses.dataclass(frozen=True)
class GpSpec:
    """Static FTC model description."""

    kern: Kern
    n_data: int
    input_dim: int
    output_dim: int
    learn_scales: bool = False      # isOutputScaleLearnt

    approx = FTC

    def n_params(self) -> int:
        return self.kern.n_params + (self.output_dim if self.learn_scales else 0)

    def unpack(self, theta: torch.Tensor):
        """theta (unconstrained) → (kern_params_constrained, scales or None)."""
        nk = self.kern.n_params
        kp = tr.apply_atox(self.kern.transform_codes(), theta[:nk])
        scales = theta[nk:nk + self.output_dim] if self.learn_scales else None
        return kp, scales

    def pack(self, kern_params, scales=None) -> np.ndarray:
        """Constrained quantities → unconstrained theta (numpy float64)."""
        kp = torch.as_tensor(np.asarray(kern_params, dtype=np.float64))
        parts = [tr.apply_xtoa(self.kern.transform_codes(), kp).numpy()]
        if self.learn_scales:
            parts.append(np.asarray(scales, dtype=np.float64))
        return np.concatenate(parts)


def log_likelihood(spec: GpSpec, theta, X, y, bias, fixed_scales):
    """logLikelihood(θ) (CGp.cpp:913-1014), FTC branch; all tensors on one
    device in its working dtype."""
    kp, scales = spec.unpack(theta)
    scales = scales if spec.learn_scales else fixed_scales
    m = (y - bias[None, :]) / scales[None, :]
    N, D = spec.n_data, spec.output_dim
    mode = select_evidence_mode(N)
    if mode == "lazy":
        logdetK, quad = kern_evidence_lazy(spec.kern, kp, X, m, force=True)
    elif mode == "panel":
        logdetK, quad = kern_evidence_panel(spec.kern, kp, X, m)
    else:
        K = spec.kern.gram(kp, X)
        logdetK, quad, _L = linalg.evidence_terms(K, m)
    Lacc = quad + D * logdetK
    if spec.learn_scales:
        Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
    L = -0.5 * Lacc
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    return L - D * N * ndlutil.HALFLOGTWOPI


def make_objective(spec: GpSpec, X, y, bias, fixed_scales):
    """nlml(θ) = −logLikelihood(θ) over fixed data tensors."""
    def nlml(theta):
        return -log_likelihood(spec, theta, X, y, bias, fixed_scales)
    return nlml


def posterior_state(spec: GpSpec, theta, X, y, bias, fixed_scales,
                    explicit_inverse: bool = False):
    """Everything batch-independent of posteriorMeanVar, factored once:
    L = chol(K), α = K⁻¹m and, with `explicit_inverse`, L⁻¹ (so each batch's
    variance solve is a GEMM)."""
    kp, scales = spec.unpack(theta)
    scales = scales if spec.learn_scales else fixed_scales
    m = (y - bias[None, :]) / scales[None, :]
    K = spec.kern.gram(kp, X)
    L, _ = linalg.jitchol(K)
    del K
    return dict(kp=kp, scales=scales, bias=bias, X=X, L=L,
                alpha=linalg.chol_solve(L, m),
                Linv=linalg.blocked_tri_inv(L) if explicit_inverse else None)


def posterior_apply(spec: GpSpec, st, Xtest):
    """One batch of predictive mean and variance against a posterior_state."""
    kp, scales = st["kp"], st["scales"]
    kstar_diag = spec.kern.diag(kp, Xtest)
    kX = spec.kern.compute(kp, st["X"], Xtest)            # (N, T)
    mu0 = kX.T @ st["alpha"]                              # (T, D)
    v = st["Linv"] @ kX if st["Linv"] is not None else linalg.tri_solve(st["L"], kX)
    # clamp at 0: near-singular K, or test points on training points, can
    # round the variance slightly negative (the f32 explicit-inverse GEMM
    # most of all), and clients take its square root
    var0 = torch.clamp(kstar_diag - torch.sum(v * v, dim=0), min=0.0)
    mu = mu0 * scales[None, :] + st["bias"][None, :]
    var = var0[:, None] * (scales ** 2)[None, :]
    return mu, var


def posterior(spec: GpSpec, theta, X, y, bias, fixed_scales, Xtest):
    """Predictive (mu, varsigma), each (T, D) (posteriorMeanVar)."""
    st = posterior_state(spec, theta, X, y, bias, fixed_scales)
    return posterior_apply(spec, st, Xtest)


class GP:
    """CGp-equivalent FTC model: data and the current parameter vector.

    X, y, bias, fixed_scales and theta are float64 numpy arrays, as in
    gpc_tpu; the data move to `device` once, in its working dtype (float32
    on CUDA, float64 on the CPU).  `device=None` means the card, and raises
    when there is none: pass device="cpu" for the CPU.  bias = column means
    when centring, scale = column std when scaling (gp.cpp:370-410)."""

    def __init__(self, kern: Kern, X, y, approx: str = FTC,
                 learn_scales: bool = False, centre: bool = True,
                 scale_data: bool = False, device=None):
        if approx != FTC:
            raise NotImplementedError(
                f"approximation {approx!r} is not ported to gpc_tpu_torch yet "
                f"(ROADMAP.md, queue 1 item 7); FTC is")
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.X, self.y = X, y
        N, q = X.shape
        D = y.shape[1]
        self.spec = GpSpec(kern=kern, n_data=N, input_dim=q, output_dim=D,
                           learn_scales=learn_scales)
        self.bias = y.mean(axis=0) if centre else np.zeros(D)
        self.fixed_scales = y.std(axis=0, ddof=1) if scale_data else np.ones(D)
        self.theta = self.spec.pack(
            kern.default_params(),
            scales=self.fixed_scales if learn_scales else None)
        self.device = resolve_device(device)
        self.Xd = as_tensor(X, self.device)
        self.yd = as_tensor(y, self.device)

    def _args(self):
        """(theta, X, y, bias, fixed_scales) as device tensors."""
        return (as_tensor(self.theta, self.device), self.Xd, self.yd,
                as_tensor(self.bias, self.device),
                as_tensor(self.fixed_scales, self.device))

    def log_likelihood(self) -> float:
        return float(log_likelihood(self.spec, *self._args()))

    def value_and_grad_fn(self):
        """w (float64 numpy) → (nlml, ∇nlml) as float64, computed on the
        model's device in its working dtype (make_objective, autograd)."""
        _, X, y, bias, scales = self._args()
        nlml = make_objective(self.spec, X, y, bias, scales)

        def vag(w):
            w = np.array(w, dtype=np.float64)       # a writable copy
            theta = as_tensor(w, self.device).requires_grad_(True)
            f = nlml(theta)
            g = None
            if f.requires_grad:
                (g,) = torch.autograd.grad(f, theta, allow_unused=True)
            g = torch.zeros_like(theta) if g is None else g
            return float(f.detach()), g.detach().cpu().numpy().astype(np.float64)
        return vag

    def optimise(self, iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, optimiser: str = "scg",
                 verbose: int = 0, ckpt_path: str = None,
                 ckpt_every: int = 50, resume: bool = False):
        """SCG by default (runDefaultOptimiser, COptimisable.h:183-203), as
        gpc_tpu's GP.optimise.  At verbose > 2 with fewer than 40 parameters
        a finite-difference gradient check runs first (CGp.cpp:1544-1545).
        ckpt_path writes the SCG state every `ckpt_every` iterations;
        resume=True continues a killed run from that file."""
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
                            as_tensor(np.asarray(Xtest, dtype=np.float64), self.device))
        return mu.cpu().numpy(), var.cpu().numpy()

    def kern_params(self) -> np.ndarray:
        kp, _ = self.spec.unpack(torch.as_tensor(self.theta))
        return kp.numpy()

    def scales(self) -> np.ndarray:
        _, s = self.spec.unpack(torch.as_tensor(self.theta))
        return s.numpy() if s is not None else self.fixed_scales

    def display(self):
        """Model summary (CGp::display, CGp.cpp:1583-1604)."""
        lines = ["Gaussian process model:",
                 f"  Data dimension: {self.spec.output_dim}",
                 f"  Number of data: {self.spec.n_data}",
                 f"  Approximation type: {self.spec.approx}"]
        for name, val in zip(self.spec.kern.display_names(), self.kern_params()):
            lines.append(f"  {name}: {val}")
        return "\n".join(lines)
