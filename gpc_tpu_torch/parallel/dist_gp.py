"""Distributed GP likelihoods: row-block sharded data, all-reduced evidence
(counterpart of gpc_tpu/parallel/dist_gp.py).

Each rank holds one row block of (X, y) and a mask (1 for a real row, 0
for padding); θ and everything computed from it alone are replicated.

* **Sparse (DTC / DTCVAR / FITC).**  X_u is replicated, the data rows
  sharded.  Each rank computes its K_uf slab (a K1/K4 launch on the card)
  and its share of the M × M moments, traces and scalars of the port's
  whitened forms (models/gp.py), which are all-reduced; the collapsed
  evidence is then evaluated replicated.  PITC is not in gpc_tpu's module
  and is not here.
* **FTC.**  Each rank computes its row block of K against the all-gathered
  X (a K1/K4 launch); K and m are all-gathered, the diagonal and the padding
  rows are set to the kernel's diagonal and to the identity, and the
  Cholesky is replicated (jitchol).

The gradient.  The objective is f(θ) = R(θ, Σ_r s_r(θ)): replicated terms
R that every rank computes in full, and local terms s_r that each rank
computes for its rows only.  A tensor crosses from the local graph into the
replicated one through `_AllReduce` (forward: the sum over ranks; backward:
the identity, since the cotangent of a replicated tensor is the same on
every rank) or `_AllGather` (backward: this rank's block of the cotangent).
A tensor crosses from the replicated graph into the local one through
`_Share` (forward: the identity; backward: the sum over ranks of the local
cotangents).  So θ̄ = ∂R/∂θ + Σ_r ∂s_r/∂θ on every rank, each part counted
once: torch.autograd.grad of the objective is the single-process gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gpc_tpu_torch import as_tensor, linalg, ndlutil
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gp import DTC, DTCVAR, FITC, FTC, GpSpec
from gpc_tpu_torch.optim import numpy_value_and_grad, scg
from gpc_tpu_torch.parallel.mesh import gather_rows

APPROXES = (FTC, DTC, DTCVAR, FITC)


class _AllReduce(torch.autograd.Function):
    """Σ_r x_r on every rank; backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Share(torch.autograd.Function):
    """A replicated tensor entering a rank's local computation: forward the
    identity; backward the all-reduced local cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """The row blocks of every rank, concatenated in rank order; backward
    this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.mesh.size, dim=0)[ctx.mesh.rank], None


def all_reduce(x, mesh):
    return _AllReduce.apply(x, mesh.group)


def share(x, mesh):
    return _Share.apply(x, mesh.group)


def all_gather_rows(x, mesh):
    return _AllGather.apply(x, mesh)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def make_dist_objective(spec: GpSpec, mesh, bias, fixed_scales, n_valid: int):
    """nlml(theta, X, y, mask) of the row-sharded data: theta the
    unconstrained parameters (a tensor on the mesh's device, the same on
    every rank, the single-process model's layout), X / y / mask this rank's
    row blocks (mask 1.0 for real rows, 0.0 for padding) as tensors on the
    mesh's device.  Returns the replicated 0-d objective, differentiable in
    theta.  n_valid is the true N (= spec.n_data)."""
    if spec.approx not in APPROXES:
        raise ValueError(f"make_dist_objective: approx {spec.approx!r} is not "
                         f"distributed (one of {', '.join(APPROXES)})")
    if spec.inducing_fixed:
        raise ValueError("make_dist_objective: fixed inducing inputs are not distributed")
    if n_valid != spec.n_data:
        raise ValueError(f"make_dist_objective: n_valid {n_valid} != spec.n_data "
                         f"{spec.n_data}")
    bias = as_tensor(np.asarray(bias, dtype=np.float64), mesh.device)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), mesh.device)
    N, D = spec.n_data, spec.output_dim

    def nlml(theta, Xl, yl, maskl):
        X_u, kp, scales, beta = spec.unpack(theta)                    # replicated
        X_u_l, kp_l, scales_l, beta_l = spec.unpack(share(theta, mesh))   # local uses
        scales = scales if spec.learn_scales else fixed_scales
        scales_l = scales_l if spec.learn_scales else fixed_scales
        ml = (yl - bias[None, :]) / scales_l[None, :] * maskl[:, None]
        if spec.approx == FTC:
            Lacc = _ftc_lacc(spec, mesh, kp, kp_l, Xl, ml, maskl)
        else:
            Lacc = _sparse_lacc(spec, mesh, kp, kp_l, X_u, X_u_l, beta, beta_l, Xl, ml,
                                maskl)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
        L = -0.5 * Lacc
        L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        return -(L - D * N * ndlutil.HALFLOGTWOPI)

    return nlml


def _ftc_lacc(spec, mesh, kp, kp_l, Xl, ml, maskl):
    """quad + D·logdet K of the all-gathered K (one row block a rank)."""
    Xg = all_gather_rows(Xl, mesh)           # data: no gradient
    maskg = all_gather_rows(maskl, mesh)
    K = all_gather_rows(spec.kern.compute(kp_l, Xl, Xg), mesh)
    m = all_gather_rows(ml, mesh)
    # padding rows and columns knocked to the identity, the diagonal the
    # kernel's own (white included), as gram's diagonal overwrite
    K = K * (maskg[:, None] * maskg[None, :])
    diag = torch.where(maskg > 0, spec.kern.diag(kp, Xg), torch.ones_like(maskg))
    K = torch.diagonal_scatter(K, diag)
    logdetK, quad, _ = linalg.evidence_terms(K, m)
    return quad + spec.output_dim * logdetK


def _sparse_lacc(spec, mesh, kp, kp_l, X_u, X_u_l, beta, beta_l, Xl, ml, maskl):
    """Lacc of DTC / DTCVAR / FITC (models/gp._sparse_lacc's whitened forms)
    from all-reduced row-block moments."""
    N, D, M = spec.n_data, spec.output_dim, spec.num_active
    K_uu = spec.kern.gram(kp, X_u)
    L_uu, _ = linalg.jitchol(K_uu)
    L_uu_l = share(L_uu, mesh)
    K_ufl = spec.kern.compute(kp_l, X_u_l, Xl) * maskl[None, :]
    W = linalg.tri_solve(L_uu_l, K_ufl)                  # L_uu⁻¹ K_uf, this rank's columns
    logb = torch.log(beta)
    if spec.approx in (DTC, DTCVAR):
        VV = all_reduce(W @ W.T, mesh)
        Vm = all_reduce(W @ ml, mesh)
        mm = all_reduce(torch.sum(ml * ml), mesh)
        Am = _eye(M, VV) / beta + VV
        L_m, _ = linalg.jitchol(Am)
        quad = torch.sum(torch.square(linalg.tri_solve(L_m, Vm)))
        Lacc = D * ((M - N) * logb + linalg.chol_logdet(L_m))
        Lacc = Lacc - beta * (quad - mm)
        if spec.approx == DTCVAR:
            diagD = beta_l * (spec.kern.diag(kp_l, Xl) - torch.sum(W * W, dim=0)) * maskl
            Lacc = Lacc + D * all_reduce(torch.sum(diagD), mesh)
        return Lacc
    # FITC
    diagD = 1.0 + beta_l * (spec.kern.diag(kp_l, Xl) - torch.sum(W * W, dim=0))
    diagD = torch.where(maskl > 0, diagD, torch.ones_like(diagD))
    sDinv = torch.sqrt(1.0 / diagD)
    scaledM = ml * sDinv[:, None]
    V = W * sDinv[None, :]
    VV = all_reduce(V @ V.T, mesh)
    Vs = all_reduce(V @ scaledM, mesh)
    logdetD = all_reduce(torch.sum(torch.log(diagD)), mesh)
    smm = all_reduce(torch.sum(scaledM * scaledM), mesh)
    Am = _eye(M, VV) / beta + VV
    L_m, _ = linalg.jitchol(Am)
    bet = linalg.tri_solve(L_m, Vs)
    # the reference's extra N·log 2π (CGp.cpp:962-988), as the single model
    Lacc = (M - N) * logb + N * ndlutil.LOGTWOPI
    Lacc = Lacc + logdetD + 2.0 * torch.sum(torch.log(torch.diagonal(L_m)))
    Lacc = Lacc * D
    return Lacc + beta * (smm - torch.sum(bet * bet))


def make_dist_train_step(spec: GpSpec, mesh, bias, fixed_scales, n_valid: int):
    """step(theta, X, y, mask, iters) → the ScgResult of `iters` SCG
    iterations on the distributed objective.  SCG runs on the host in
    float64 (optim/scg.py); every rank sees the same all-reduced values and
    gradients, so every rank takes the same trajectory."""
    nlml = make_dist_objective(spec, mesh, bias, fixed_scales, n_valid)

    def step(theta, X, y, mask, iters: int):
        Xl, yl, ml = (as_tensor(a, mesh.device) for a in (X, y, mask))
        vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
        return scg(vag, np.asarray(theta, dtype=np.float64), max_iters=iters)

    return step
