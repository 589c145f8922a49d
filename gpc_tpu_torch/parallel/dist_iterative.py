"""The matrix-free evidence with the kernel MVM row-sharded: distributed
K·V, CG and SLQ (counterpart of gpc_tpu/parallel/dist_iterative.py).

  * Each rank holds a row block X_l and computes its rows of K·V against
    the all-gathered X, block by block (ops/iterative._raw_mvm: a K1/K4
    launch a block on the card); one all-gather of the (N/world, D′)
    result a MVM reassembles the replicated product.
  * The CG / Lanczos vector arithmetic runs replicated on every rank from
    the gathered products, so every rank takes the same iterations and
    leaves CG at the same one.
  * Padding rows are masked to the identity: the operator is
    mask·K·mask + (I − mask), whose padding eigenvalues are 1, so they add
    nothing to logdet or to the quad.

The probes are the port's single-process engine's (`rademacher_probes` from
cfg.seed at the padded N), or the caller's; the backward reuses the
forward's.  The backward contracts this rank's rows only (ops/iterative
.mvm_vjp with a row range) against the gathered X and α, Z, W; the gathered
X enters that local work through `share`, so its cotangent is all-reduced
before all_gather's backward takes this rank's block (dist_gp.py).
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, ndlutil
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.kernels import Kern
from gpc_tpu_torch.ops import iterative as it
from gpc_tpu_torch.ops.iterative import IterConfig, iter_config
from gpc_tpu_torch.parallel.dist_gp import all_gather_rows, share
from gpc_tpu_torch.parallel.mesh import Mesh, gather_rows


def _local_mvm_fn(kern: Kern, p, Xg, maskg, mesh: Mesh, block: int):
    """V ↦ all_gather(this rank's rows of (mask·K·mask + (I − mask))·V):
    the replicated-in, replicated-out distributed MVM."""
    nl = Xg.shape[0] // mesh.size
    lo, hi = mesh.rank * nl, (mesh.rank + 1) * nl
    maskl = maskg[lo:hi, None]
    white = kern.white(p)

    def mvm(V):
        Vm = V * maskg[:, None]
        # this rank's rows of the white-free K·V (gpc_tpu's _rows_mvm)
        out_l = (it._raw_mvm(kern, p, Xg, Vm, block, rows=(lo, hi)) + white * Vm[lo:hi]) * maskl
        return gather_rows(mesh, out_l + (1.0 - maskl) * V[lo:hi])

    return mvm


class _DistIterEvidence(torch.autograd.Function):
    """(logdet, quad) of the masked operator, from the replicated p, X, m,
    mask; the backward gives this rank's contributions to p̄ and X̄ (its rows
    of the contraction) and the replicated m̄ = 2·g_quad·α."""

    @staticmethod
    def forward(ctx, kern, cfg, mesh, Ztr, Zslq, p, Xg, mg, maskg):
        N, D = mg.shape
        mvm = _local_mvm_fn(kern, p, Xg, maskg, mesh, cfg.block)
        B = torch.cat([mg, Ztr], dim=1)
        if cfg.precond_rank > 0:
            # pivoted-Cholesky/Woodbury preconditioner on the gathered X,
            # replicated (the greedy pivot scan is sequential): padding rows
            # are never pivots and the solve is the identity there
            Lk = it.pivoted_cholesky_masked(kern, p, Xg, maskg, cfg.precond_rank)
            wsolve = it.woodbury_preconditioner(Lk, kern.white(p) + 1e-8)

            def pre(R):
                return wsolve(R * maskg[:, None]) * maskg[:, None] + (1.0 - maskg[:, None]) * R

            sol = it.pcg_solve(mvm, B, pre, max_iters=cfg.cg_iters)
        else:
            sol = it.cg_solve(mvm, B, max_iters=cfg.cg_iters)
        alpha, W = sol.x[:, :D], sol.x[:, D:]
        quad = torch.sum(mg * alpha)
        logdet = it.slq_logdet(mvm, N, lanczos_iters=cfg.lanczos_iters, Z=Zslq)
        it.LAST_SOLVE = sol
        ctx.kern, ctx.cfg, ctx.mesh = kern, cfg, mesh
        ctx.save_for_backward(p, Xg, maskg, alpha, W, Ztr)
        return logdet, quad

    @staticmethod
    def backward(ctx, g_ld, g_quad):
        p, Xg, maskg, alpha, W, Ztr = ctx.saved_tensors
        kern, cfg, mesh = ctx.kern, ctx.cfg, ctx.mesh
        need_p, need_X, need_m = ctx.needs_input_grad[5:8]
        nl = Xg.shape[0] // mesh.size
        lo, hi = mesh.rank * nl, (mesh.rank + 1) * nl
        pbar = Xbar = None
        if need_p or need_X:
            # this rank's rows of ḡ_ld·tr̂/T − ḡ_quad·αᵀKα (the identity part
            # of the masked operator is (p, X)-free)
            mask = maskg[:, None]
            V = torch.cat([alpha, Ztr], dim=1) * mask
            G = torch.cat([-g_quad * alpha[lo:hi], (g_ld / cfg.trace_probes) * W[lo:hi]],
                          dim=1) * mask[lo:hi]
            pbar, Xbar = it.mvm_vjp(kern, p, Xg, V, G, cfg.block, need_p, need_X, rows=(lo, hi))
        mbar = 2.0 * g_quad * alpha if need_m else None
        return None, None, None, None, None, pbar, Xbar, mbar, None


def make_dist_iterative_evidence(kern: Kern, mesh: Mesh, cfg: IterConfig | None = None):
    """evidence(p, X, m, mask, probes=None) → replicated (logdet, quad):
    p the kernel's constrained parameters (replicated), X / m / mask this
    rank's row blocks.  The distributed twin of
    ops.iterative.kern_evidence_iterative: the same fixed-probe estimator,
    so with the same probes the two agree to CG tolerance.  `probes` =
    (Z_trace (N, T), Z_slq (N, P)) at the padded N; by default the
    single-process engine's seeded draw.  Differentiable in (p, X, m)."""
    cfg = iter_config() if cfg is None else cfg

    def evidence(p, Xl, ml, maskl, probes=None):
        Xg, maskg = all_gather_rows(Xl, mesh), gather_rows(mesh, maskl)
        mg = all_gather_rows(ml, mesh)
        N = Xg.shape[0]
        if probes is None:
            Ztr, Zslq = it.rademacher_probes(cfg.seed, N, cfg.trace_probes, cfg.probes,
                                             Xg.dtype, Xg.device)
        else:
            Ztr, Zslq = (torch.as_tensor(z, dtype=Xg.dtype, device=Xg.device) for z in probes)
        return _DistIterEvidence.apply(kern, cfg, mesh, Ztr, Zslq, share(p, mesh),
                                       share(Xg, mesh), mg, maskg)

    return evidence


def dist_iterative_nlml(kern: Kern, mesh: Mesh, bias, fixed_scales, n_valid: int,
                        cfg: IterConfig | None = None, probes=None):
    """nlml(theta, X, y, mask) of a distributed FTC GP over the matrix-free
    engine: theta the kernel's unconstrained parameters (the single-process
    FTC layout without learnt scales), X / y / mask this rank's row blocks.
    Returns the replicated 0-d objective, differentiable in theta."""
    bias = as_tensor(np.asarray(bias, dtype=np.float64), mesh.device)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), mesh.device)
    evidence = make_dist_iterative_evidence(kern, mesh, cfg)
    codes = kern.transform_codes()

    def nlml(theta, Xl, yl, maskl):
        kp = tr.apply_atox(codes, theta)
        ml = (yl - bias[None, :]) / fixed_scales[None, :] * maskl[:, None]
        logdet, quad = evidence(kp, Xl, ml, maskl, probes)
        D = yl.shape[1]
        L = -0.5 * (quad + D * logdet) + priors_mod.total_log_prob(kern.priors_global, kp)
        return -(L - D * n_valid * ndlutil.HALFLOGTWOPI)

    return nlml
