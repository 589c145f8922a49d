"""The GP-LVM / GPDM objective with the latent rows sharded with the
evidence (counterpart of gpc_tpu/parallel/dist_gplvm.py).

The latent coordinates live in the replicated θ (CGplvm's layout,
CGplvm.cpp:257-330).  Each rank builds the Gram rows of its slice of latent
points (a K1/K4 launch against all of X), and the row-sharded evidence runs
through chol_distributed.evidence_distributed, so one torch.autograd.grad
gives ∂NLML/∂θ, the N·q latent gradients included, with no N × N object on
any rank.

  * Dynamics (CGplvm.cpp:448-489): a second row-sharded evidence over the
    same latent rows, the sequence-break rows and columns knocked out to the
    identity on each shard, with the up-shifted Xout (break rows zeroed,
    CGplvm.cpp:231-243) as its replicated right-hand side.
  * Back constraints X = bK·A (CGplvm.cpp:683-701): bK is row-sharded with
    the data; each rank computes its rows of X with one local GEMM and X is
    one all-gather; the chain rule to A runs back through both.

gpc_tpu's quirks are kept: no 2π term, and with dynamics only X[:, 0] is
regularised.  There is no jitter rescue (chol_distributed.py).  N must
divide by the world size.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import as_tensor
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gplvm import GplvmSpec, _xout
from gpc_tpu_torch.parallel.chol_distributed import evidence_distributed
from gpc_tpu_torch.parallel.dist_gp import all_gather_rows, share
from gpc_tpu_torch.parallel.mesh import Mesh


def _gram_rows(kern, p, X_l, X, rows):
    """This rank's rows of kern.gram(p, X): the cross compute with the
    diagonal overwritten by diag(p, X_l), as gram() does."""
    own = (torch.arange(X_l.shape[0], device=X.device), rows)
    return kern.compute(p, X_l, X).index_put(own, kern.diag(p, X_l))


def make_dist_gplvm_value_and_grad(spec: GplvmSpec, mesh: Mesh, noise_bias, fixed_scales,
                                   dyn_params_fixed=None):
    """nlml(theta, y[, bK]) — the distributed CGplvm::logLikelihood
    (CGplvm.cpp:493-716), negated: theta replicated on the mesh's device, y
    this rank's (N/world, D) rows and, when spec.back_constrained, bK this
    rank's (N/world, N) rows of the back-constraint kernel matrix.  Returns
    the replicated 0-d objective, differentiable in theta (gpc_tpu returns
    jax.value_and_grad of it; the port keeps dist_gp's convention).
    `dyn_params_fixed` is needed when spec.has_dynamics and not
    spec.dyn_kern_learnt."""
    N, D, q = spec.n_data, spec.data_dim, spec.latent_dim
    if N % mesh.size:
        raise ValueError(f"make_dist_gplvm_value_and_grad: N = {N} does not divide by "
                         f"the world size {mesh.size}")
    B = N // mesh.size
    dev = mesh.device
    noise_bias = as_tensor(np.asarray(noise_bias, dtype=np.float64), dev)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), dev)
    dpf = (as_tensor(np.asarray(dyn_params_fixed, dtype=np.float64), dev)
           if dyn_params_fixed is not None else None)
    rows = mesh.rank * B + torch.arange(B, device=dev)
    if spec.has_dynamics:
        keep = torch.ones(N, dtype=noise_bias.dtype, device=dev).index_fill(
            0, torch.as_tensor(spec.break_rows(), device=dev), 0.0)
        keep_l = keep[rows]

    def nlml(theta, yl, bKl=None):
        kp_l, dp_l, Xvals_l, scales_l = spec.unpack(share(theta, mesh))
        kp, dp, Xvals, scales = spec.unpack(theta)
        scales = scales if spec.learn_scales else fixed_scales
        scales_l = scales_l if spec.learn_scales else fixed_scales
        if spec.back_constrained:
            # X = bK·A: this rank's rows by one local GEMM, X by one all-gather
            X_l = bKl @ Xvals_l
            X = all_gather_rows(X_l, mesh)        # replicated
            X_sh = share(X, mesh)                 # ... entering this rank's rows
        else:
            X, X_sh = Xvals, Xvals_l
            X_l = Xvals_l[mesh.rank * B:(mesh.rank + 1) * B]
        K_rows = _gram_rows(spec.kern, kp_l, X_l, X_sh, rows)
        m = all_gather_rows((yl - noise_bias[None, :]) / scales_l[None, :], mesh)
        logdet, quad = evidence_distributed(mesh, K_rows, m)
        Lacc = quad + D * logdet
        if spec.has_dynamics:
            dpl = dp_l if dp_l is not None else dpf
            K2 = _gram_rows(spec.dyn_kern, dpl, X_l, X_sh, rows)
            # break rows and columns to the identity (CGplvm.cpp:448-477)
            K2 = (K2 * keep_l[:, None] * keep[None, :]).index_put(
                (torch.arange(B, device=dev), rows), torch.where(
                    keep_l > 0, K2[torch.arange(B, device=dev), rows], torch.ones_like(keep_l)))
            ld2, quad2 = evidence_distributed(mesh, K2, _xout(spec, X))
            Lacc = Lacc + spec.dynamic_scaling * (quad2 + q * ld2)
            if spec.latent_regularised:
                # dynamics regularise column 0 only (CGplvm.cpp:530-534)
                Lacc = Lacc + torch.sum(X[:, 0] ** 2)
        elif spec.latent_regularised:
            Lacc = Lacc + torch.sum(X * X)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
        L = -0.5 * Lacc + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        if spec.has_dynamics and spec.dyn_kern_learnt:
            L = L + priors_mod.total_log_prob(spec.dyn_kern.priors_global, dp)
        # no 2π term: CGplvm's quirk, as models/gplvm.py
        return -L

    return nlml
