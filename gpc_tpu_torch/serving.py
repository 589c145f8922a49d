"""Batch prediction servers: factor once, then answer bucket-padded batches.

Counterpart of gpc_tpu/serving.py: GPServer and IvmServer.  `refresh` factors the
posterior state once on the model's device: for FTC K's Cholesky, α = K⁻¹m
and, with `explicit_inverse`, the blocked L⁻¹, so each batch's variance
solve is a GEMM; for a sparse model (X_u, L_uu, L_m, u), M × M factors.  `predict` serves requests in chunks of at most `chunk` rows, each
padded to a power-of-two bucket capped at `chunk`: the set of batch shapes
stays bounded at ~log2(chunk) for any stream of request sizes.  On CUDA the
Grams of the factor and each batch's cross-Gram run kernel K1 (the distance
family) or K4 (lin, poly, mlp).  IvmServer holds an IVM's d × d factor of
K + B⁻¹ per covariance structure and α = (K + B⁻¹)⁻¹m̃; a batch is its
d × T cross-Gram (K1/K4) and triangular solves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg
from gpc_tpu_torch.models.gp import GP, posterior_apply, posterior_state


class GPServer:
    """One-time-factored predictor for a `models.gp.GP`.

    `explicit_inverse` (FTC only, as in gpc_tpu) defaults to on for CUDA and
    off for the CPU (the f64 parity route).  `predict` matches `GP.predict` to numerical precision
    for any request size, ragged tails included."""

    def __init__(self, model: GP, chunk: int = 8192,
                 explicit_inverse: Optional[bool] = None):
        self.spec = model.spec
        self.device = model.device
        self.chunk = int(chunk)
        if explicit_inverse is None:
            explicit_inverse = self.device.type == "cuda"
        self.explicit_inverse = bool(explicit_inverse) and not self.spec.sparse
        self.refresh(model)

    def refresh(self, model: GP):
        """Re-factor from the model's current parameters, bias and scales."""
        self.state = posterior_state(self.spec, *model._args(), model._xu_fixed(),
                                     explicit_inverse=self.explicit_inverse)

    def _bucket(self, t: int) -> int:
        """Padded batch size for a t-row piece: the next power of two,
        capped at `chunk`."""
        b = 1
        while b < t:
            b <<= 1
        return max(min(b, self.chunk), 1)

    def _apply(self, Xt):
        return posterior_apply(self.spec, self.state, Xt)

    def predict(self, Xtest):
        """(mu, varsigma) as numpy arrays for any number of test rows."""
        Xtest = np.asarray(Xtest, dtype=np.float64)
        T = Xtest.shape[0]
        if T == 0:
            D = self.spec.output_dim
            return np.zeros((0, D)), np.zeros((0, D))
        mus, vars_ = [], []
        for c0 in range(0, T, self.chunk):
            Xb = Xtest[c0:c0 + self.chunk]
            rows = Xb.shape[0]
            pad = self._bucket(rows) - rows
            Xt = as_tensor(Xb, self.device)
            if pad:
                Xt = torch.nn.functional.pad(Xt, (0, 0, 0, pad))
            mu, var = self._apply(Xt)
            mus.append(mu[:rows].cpu().numpy())
            vars_.append(var[:rows].cpu().numpy())
        return np.concatenate(mus, axis=0), np.concatenate(vars_, axis=0)


class IvmServer(GPServer):
    """Factor-once predictor for a `models.ivm.IVM` (CIvm::posteriorMeanVar,
    CIvm.cpp:126-163): d active points, a d × d Cholesky factor of K + B⁻¹
    per covariance structure and α = (K + B⁻¹)⁻¹m̃, so a batch is one
    cross-Gram and its solves.  The same bucket-padded chunks as GPServer;
    `out` maps (mu, varsigma) through the noise model (CIvm::out);
    `refresh(model)` re-factors after a relearn."""

    def __init__(self, model, chunk: int = 8192):
        self.spec = model.spec
        self.device = model.device
        self.chunk = int(chunk)
        self.refresh(model)

    def refresh(self, model):
        """Re-factor from the model's current kernel and site parameters."""
        spec, st = self.spec, model.state
        kp = model._t(model.kern_params)
        Xa = model._t(model.active_X())
        K = spec.kern.gram(kp, Xa)
        Ls, alphas = [], []
        for j in range(1 if spec.noise.spherical else spec.output_dim):
            Lc, _ = linalg.jitchol(K + torch.diag(1.0 / st.beta_site[:, j]))
            Ls.append(Lc)
            alphas.append(linalg.chol_solve(
                Lc, st.m_site if spec.noise.spherical else st.m_site[:, j:j + 1]))
        self.state = dict(kp=kp, Xa=Xa, L=torch.stack(Ls, dim=0),
                          alpha=torch.cat(alphas, dim=1),
                          noise_params=model._t(model.noise_params))

    def _apply(self, Xt):
        spec, st = self.spec, self.state
        kX = spec.kern.compute(st["kp"], st["Xa"], Xt)              # (d, T)
        kdiag = spec.kern.diag(st["kp"], Xt)
        J = st["L"].shape[0]
        v = torch.linalg.solve_triangular(st["L"], kX[None].expand(J, -1, -1), upper=False)
        vs = torch.clamp(kdiag[None, :] - torch.sum(v * v, dim=1), min=0.0)   # (J, T)
        mu = kX.T @ st["alpha"]                                     # (T, D)
        var = vs[0][:, None].repeat(1, spec.output_dim) if spec.noise.spherical else vs.T
        return mu, var

    def out(self, Xtest):
        """Predicted outputs through the noise model (CIvm::out), numpy."""
        mu, vs = self.predict(Xtest)
        out = self.spec.noise.out(self.state["noise_params"], as_tensor(mu, self.device),
                                  as_tensor(vs, self.device))
        return out.cpu().numpy()
