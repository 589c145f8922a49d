"""The FTC evidence, its gradient and its posterior with K row-sharded
(counterpart of gpc_tpu/parallel/dist_ftc.py).

dist_gp.make_dist_objective's FTC path all-gathers K and factors it on
every rank, O(N²) memory a rank.  Here K, its factor and its cotangent stay
row-sharded, O(N²/world) a rank:

  build     this rank's masked Gram rows (a K1/K4 launch against the
            all-gathered X) and the all-gathered scaled targets, from θ;
  evidence  chol_distributed.evidence_distributed: factor, forward solve
            and logdet in one panel sweep; its backward runs the reverse
            sweeps and gives this rank's rows of K̄ = ½(α·αᵀ − D·K⁻¹)
            (CGp::updateCovGradient, CGp.cpp:666-679);
  objective the replicated NLML, differentiated by torch.autograd.grad.

Padding rows (mask 0) are the identity in K and zero in m, so they add
nothing to either term.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, ndlutil
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gp import FTC, GpSpec
from gpc_tpu_torch.parallel.chol_distributed import (_backward_solve_sweep,
                                                     _factor_solve_sweep,
                                                     evidence_distributed)
from gpc_tpu_torch.parallel.dist_gp import all_gather_rows, share
from gpc_tpu_torch.parallel.mesh import Mesh, gather_rows


def _check_spec(spec: GpSpec, n_valid: int, what: str):
    if spec.approx != FTC:
        raise ValueError(f"{what}: approx {spec.approx!r} is not FTC")
    if n_valid != spec.n_data:
        raise ValueError(f"{what}: n_valid {n_valid} != spec.n_data {spec.n_data}")


def _masked_rows(spec: GpSpec, mesh: Mesh, kp, Xl, Xg, maskl, maskg):
    """This rank's Gram rows, padding rows and columns knocked out and the
    diagonal the kernel's own (white included), 1 on padding rows."""
    B = Xl.shape[0]
    K_rows = spec.kern.compute(kp, Xl, Xg) * (maskl[:, None] * maskg[None, :])
    own = (torch.arange(B, device=Xl.device), mesh.rank * B + torch.arange(B, device=Xl.device))
    diag = torch.where(maskl > 0, spec.kern.diag(kp, Xl), torch.ones_like(maskl))
    return K_rows.index_put(own, diag)


def make_dist_ftc_value_and_grad(spec: GpSpec, mesh: Mesh, bias, fixed_scales, n_valid: int):
    """nlml(theta, X, y, mask) of the row-sharded data with K row-sharded:
    theta the unconstrained parameters on the mesh's device (the same on
    every rank, the single-process FTC layout), X / y / mask this rank's row
    blocks (mask 1.0 for real rows, 0.0 for padding).  Returns the
    replicated 0-d objective; torch.autograd.grad gives θ̄ (gpc_tpu returns
    jax.value_and_grad of the same function; the port keeps
    dist_gp.make_dist_objective's convention, and optim.numpy_value_and_grad
    adapts it for SCG)."""
    _check_spec(spec, n_valid, "make_dist_ftc_value_and_grad")
    bias = as_tensor(np.asarray(bias, dtype=np.float64), mesh.device)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), mesh.device)
    N, D = spec.n_data, spec.output_dim

    def nlml(theta, Xl, yl, maskl):
        _, kp_l, scales_l, _ = spec.unpack(share(theta, mesh))
        scales_l = scales_l if spec.learn_scales else fixed_scales
        Xg, maskg = gather_rows(mesh, Xl), gather_rows(mesh, maskl)     # data
        K_rows = _masked_rows(spec, mesh, kp_l, Xl, Xg, maskl, maskg)
        m = all_gather_rows((yl - bias[None, :]) / scales_l[None, :] * maskl[:, None], mesh)
        logdet, quad = evidence_distributed(mesh, K_rows, m)
        _, kp, scales, _ = spec.unpack(theta)
        L = -0.5 * (quad + D * logdet) + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        if spec.learn_scales:
            L = L - torch.sum(torch.log(torch.abs(scales)))
        return -(L - D * N * ndlutil.HALFLOGTWOPI)

    return nlml


def make_dist_ftc_posterior(spec: GpSpec, mesh: Mesh, bias, fixed_scales, n_valid: int):
    """posterior(theta, X, y, mask, Xtest) → replicated (mu, var), each
    (T, D), with K row-sharded: the distributed CGp::posteriorMeanVar.  One
    sweep factors K and forward-solves [m | k*] together, a backward sweep
    gives α = K⁻¹m; mu = k*ᵀα, var = diag k** − ‖L⁻¹k*‖².  Forward only;
    Xtest is replicated (T modest: k* is (N, T) on every rank)."""
    _check_spec(spec, n_valid, "make_dist_ftc_posterior")
    bias = as_tensor(np.asarray(bias, dtype=np.float64), mesh.device)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), mesh.device)
    D = spec.output_dim

    @torch.no_grad()
    def posterior(theta, Xl, yl, maskl, Xtest):
        B = Xl.shape[0]
        _, kp, scales, _ = spec.unpack(theta)
        scales = scales if spec.learn_scales else fixed_scales
        Xg, maskg = gather_rows(mesh, Xl), gather_rows(mesh, maskl)
        K_rows = _masked_rows(spec, mesh, kp, Xl, Xg, maskl, maskg)
        m = gather_rows(mesh, (yl - bias[None, :]) / scales[None, :] * maskl[:, None])
        kX = gather_rows(mesh, spec.kern.compute(kp, Xl, Xtest) * maskl[:, None])   # (N, T)
        L_local, V, _ = _factor_solve_sweep(K_rows, torch.cat([m, kX], dim=1), mesh, B)
        alpha = _backward_solve_sweep(L_local, V[:, :D], mesh, B)
        v_k = V[:, D:]
        mu = (kX.mT @ alpha) * scales[None, :] + bias[None, :]
        # clamped at 0 as models/gp.posterior_apply clamps (clients take its
        # square root); gpc_tpu's distributed posterior does not clamp
        var0 = torch.clamp(spec.kern.diag(kp, Xtest) - torch.sum(v_k * v_k, dim=0), min=0.0)
        return mu, var0[:, None] * (scales ** 2)[None, :]

    return posterior
