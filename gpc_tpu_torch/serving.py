"""Batch prediction servers: factor once, then answer bucket-padded batches.

Counterpart of gpc_tpu/serving.py: GPServer and IvmServer.  `refresh` factors the
posterior state once on the model's device: for FTC K's Cholesky, α = K⁻¹m
and, with `explicit_inverse`, the blocked L⁻¹, so each batch's variance
solve is a product over L⁻¹'s lower triangle alone, a few batched GEMMs
(`linalg.tri_apply`, counted a chunk under `serve.tri_apply`); for a sparse
model (X_u, L_uu, L_m, u), M × M factors.  `predict` serves requests in
chunks of at most `chunk` rows, each padded to a power-of-two bucket
capped at `chunk`: the set of batch shapes stays bounded at ~log2(chunk)
for any stream of request sizes.  On CUDA the
Grams of the factor and each batch's cross-Gram run kernel K1 (the distance
family) or K4 (lin, poly, mlp).  IvmServer holds an IVM's d × d factor of
K + B⁻¹ per covariance structure and α = (K + B⁻¹)⁻¹m̃; a batch is its
d × T cross-Gram (K1/K4) and triangular solves.

`predict` counts the rows asked for and the rows its buckets add
(`serve.rows`, `serve.pad_rows` in utils/profiling.COUNTS) and, while a
profiler records, spans each chunk's staging onto the device
(`gpc.serve.stage`), its posterior (`gpc.serve.apply`) and the copies back,
the last chunk's with the answer's assembly (`gpc.serve.fetch`).

`GPServer(model, mesh=...)` serves across the ranks of a data mesh
(parallel/mesh.py): every rank holds the replicated state, computes its
row block of each bucket-padded chunk, and an all-gather gives every rank
the whole (mu, varsigma).  `chunk` must then be a multiple of the world
size, and buckets are rounded up to one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg
from gpc_tpu_torch.models.gp import GP, posterior_apply, posterior_state
from gpc_tpu_torch.utils.profiling import COUNTS, span


class GPServer:
    """One-time-factored predictor for a `models.gp.GP`.

    `explicit_inverse` (FTC only, as in gpc_tpu) defaults to on for CUDA and
    off for the CPU (the f64 parity route).  `predict` matches `GP.predict` to numerical precision
    for any request size, ragged tails included.  With `mesh` each rank
    computes its rows of every chunk (the model's device must be the
    mesh's)."""

    def __init__(self, model: GP, chunk: int = 8192,
                 explicit_inverse: Optional[bool] = None, mesh=None):
        self.spec = model.spec
        self.device = model.device
        self.chunk = int(chunk)
        self.mesh = mesh
        if mesh is not None:
            if self.chunk % mesh.size:
                raise ValueError(f"GPServer: chunk {self.chunk} is not a multiple of the "
                                 f"world size {mesh.size}")
            # torch.empty(0) names the device in full (cuda → cuda:0)
            if (torch.empty(0, device=mesh.device).device
                    != torch.empty(0, device=self.device).device):
                raise ValueError(f"GPServer: the model is on {self.device}, the mesh on "
                                 f"{mesh.device}")
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
        capped at `chunk` and, under a mesh, rounded up to a multiple of the
        world size."""
        b = 1
        while b < t:
            b <<= 1
        b = min(b, self.chunk)
        if self.mesh is not None:
            b = -(-b // self.mesh.size) * self.mesh.size
        return max(b, 1)

    def _apply(self, Xt):
        if self.mesh is None:
            return posterior_apply(self.spec, self.state, Xt)
        from gpc_tpu_torch.parallel.mesh import gather_rows
        mesh = self.mesh
        rows = Xt.shape[0] // mesh.size
        mu, var = posterior_apply(self.spec, self.state,
                                  Xt[mesh.rank * rows:(mesh.rank + 1) * rows])
        return gather_rows(mesh, mu), gather_rows(mesh, var)

    def predict(self, Xtest):
        """(mu, varsigma) as numpy arrays for any number of test rows."""
        Xtest = np.asarray(Xtest, dtype=np.float64)
        T = Xtest.shape[0]
        if T == 0:
            D = self.spec.output_dim
            return np.zeros((0, D)), np.zeros((0, D))
        mus, vars_ = [], []
        for c0 in range(0, T, self.chunk):
            with span("gpc.serve.stage"):
                Xb = Xtest[c0:c0 + self.chunk]
                rows = Xb.shape[0]
                pad = self._bucket(rows) - rows
                COUNTS["serve.rows"] += rows
                COUNTS["serve.pad_rows"] += pad
                Xt = as_tensor(Xb, self.device)
                if pad:
                    Xt = torch.nn.functional.pad(Xt, (0, 0, 0, pad))
            with span("gpc.serve.apply"):
                mu, var = self._apply(Xt)
            with span("gpc.serve.fetch"):
                mus.append(mu[:rows].cpu().numpy())
                vars_.append(var[:rows].cpu().numpy())
                if c0 + self.chunk >= T:        # the last chunk joins the answer
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
        self.mesh = None
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
