"""The sparse evidences (DTC, DTCVAR, FITC) on a 2-D mesh: inducing rows ×
data rows (counterpart of gpc_tpu/parallel/dist_sparse2d.py).

The 1-D sparse path (dist_gp.py) replicates every M-sized object.  Here the
mesh is (mp, dp) (parallel/mesh.mesh_2d): mp shards the M inducing rows, dp
the N data rows, and every large object is block-resident:

    K_uf block   (M/mp, N/dp)   a rank
    K_uu, A      (M/mp, M)      row blocks over mp, replicated over dp
    factors      row blocks, by the panel Cholesky of chol_distributed
                 running over the mp axis
    e = K_uf·m   (M/mp, D)      all-reduced over dp

The evidences need logdet(K_uu), logdet(A) and a quadratic form, from the
factors' diagonals and a distributed forward substitution.  This is
gpc_tpu's non-whitened form, A = K_uu/β + K_uf·K_fu (CGp.cpp:770-773), not
the whitened form of the single-process model and dist_gp.py.

The gradient is autograd through the sweeps, with dist_gp.py's paired
collectives on each axis's own group: a tensor the same on every rank of
an axis that enters work which differs across that axis passes through
`share` on that axis, and a sum over an axis is an `all_reduce` on it.
Every rank builds the same graph (rank-dependent choices are masks), so
the backward's collectives pair up across ranks.  θ
has three views: θ_m (shared over mp: K_uu rows, A, the mp sweeps), θ_d
(shared over dp: the data rows' m, diag K) and θ_md (both: the K_uf block).

A·'s row blocks come from a ring over mp: in round s, mp rank s
broadcasts its block (a broadcast both gloo and NCCL take on CUDA tensors),
so one remote (M/mp, N/dp) chunk is live at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, ndlutil
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gp import DTC, DTCVAR, FITC, GpSpec
from gpc_tpu_torch.parallel.chol_distributed import _local_factor_step
from gpc_tpu_torch.parallel.dist_gp import all_reduce, broadcast, share
# mesh_2d is re-exported for parity of names with gpc_tpu's module only.
from gpc_tpu_torch.parallel.mesh import Mesh, Mesh2D, mesh_2d, replicated, shard_rows  # noqa: F401


def _chol_rows(S_rows, mp: Mesh, Mb: int, M: int):
    """The distributed Cholesky of the mp-row-sharded (Mb, M) block:
    (this rank's rows of L, the replicated logdet)."""
    for j in range(mp.size):
        S_rows, _ = _local_factor_step(j, S_rows, mp, Mb)
    mine = S_rows[:, mp.rank * Mb:(mp.rank + 1) * Mb]
    return S_rows, 2.0 * all_reduce(torch.sum(torch.log(torch.diagonal(mine))), mp)


def _fwd_solve_rows(L_rows, b_l, mp: Mesh, Mb: int):
    """L v = b with L row-sharded over mp: b_l this rank's (Mb, ·) rows of
    b, returns this rank's rows of v.  In round j rank j solves its
    diagonal block, the all-reduce of its solution (zero elsewhere) hands it
    to every rank, and the ranks below update their residual.  Every rank
    runs the same operations, selected by masks, so every rank's backward
    runs the same collectives in the same order; the ranks other than j
    solve against the identity, not their block j, which is upper-triangle
    zero: its NaN solution would reach the backward as 0·NaN even where
    masked out (gpc_tpu's guard, dist_sparse2d.py:86-90)."""
    r = mp.rank
    eye = torch.eye(Mb, dtype=L_rows.dtype, device=L_rows.device)
    v_l = torch.zeros_like(b_l)
    for j in range(mp.size):
        Lj = L_rows[:, j * Mb:(j + 1) * Mb]
        own = torch.tensor(r == j, device=L_rows.device)
        vj = torch.linalg.solve_triangular(torch.where(own, Lj, eye), b_l, upper=False)
        vj = share(all_reduce(torch.where(own, vj, torch.zeros_like(vj)), mp), mp)
        b_l = b_l - float(r > j) * (Lj @ vj)
        v_l = torch.where(own, vj, v_l)
    return v_l


def _ring_gram_rows(V_l, mesh: Mesh2D, Mb: int, M: int):
    """This rank's (Mb, M) row block of V·Vᵀ summed over dp, one mp rank's
    (Mb, N/dp) block live at a time."""
    mp, dp = mesh.mp, mesh.dp
    blocks = []
    for s in range(mp.size):
        V_s = share(broadcast(V_l, mp, s), mp)
        blocks.append(all_reduce(V_l @ V_s.mT, dp))
    return torch.cat(blocks, dim=1)


def make_dist2d_objective(spec: GpSpec, mesh: Mesh2D, bias, fixed_scales, n_valid: int):
    """nlml(theta, X, y, mask): theta replicated on every rank, X / y / mask
    this rank's dp row blocks (the same on every mp rank of a dp column;
    `shard_data_2d`).  DTC, DTCVAR and FITC (CGp.cpp:939-988) with every
    M-sized object 2-D-block resident; the replicated 0-d objective,
    differentiable in theta."""
    if spec.approx not in (DTC, DTCVAR, FITC):
        raise ValueError(f"make_dist2d_objective: approx {spec.approx!r} is not one of "
                         f"{DTC}, {DTCVAR}, {FITC}")
    if spec.inducing_fixed:
        raise ValueError("make_dist2d_objective: fixed inducing inputs are not distributed")
    if n_valid != spec.n_data:
        raise ValueError(f"make_dist2d_objective: n_valid {n_valid} != spec.n_data "
                         f"{spec.n_data}")
    N, D, M = spec.n_data, spec.output_dim, spec.num_active
    mp, dp = mesh.mp, mesh.dp
    if M % mp.size:
        raise ValueError(f"make_dist2d_objective: M = {M} does not divide by mp = {mp.size}")
    Mb = M // mp.size
    r = mp.rank
    dev = mesh.device
    bias = as_tensor(np.asarray(bias, dtype=np.float64), dev)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), dev)
    own = (torch.arange(Mb, device=dev), r * Mb + torch.arange(Mb, device=dev))

    def views(theta):
        X_u, kp, scales, beta = spec.unpack(theta)
        return X_u, kp, (scales if spec.learn_scales else fixed_scales), beta

    def nlml(theta, Xl, yl, maskl):
        theta_m = share(theta, mp)
        X_u, kp, scales, beta = views(theta)
        X_u_m, kp_m, _, beta_m = views(theta_m)
        _, kp_d, scales_d, beta_d = views(share(theta, dp))
        X_u_md, kp_md, _, _ = views(share(theta_m, dp))

        ml = (yl - bias[None, :]) / scales_d[None, :] * maskl[:, None]       # (Nl, D), dp
        X_u_l = X_u_m[r * Mb:(r + 1) * Mb]
        K_uu_rows = spec.kern.compute(kp_m, X_u_l, X_u_m).index_put(
            own, spec.kern.diag(kp_m, X_u_l))                                 # (Mb, M), mp
        K_ufl = spec.kern.compute(kp_md, X_u_md[r * Mb:(r + 1) * Mb], Xl) * maskl[None, :]
        L_uu_rows, logdet_uu = _chol_rows(K_uu_rows, mp, Mb, M)

        if spec.approx in (DTC, DTCVAR):
            e_l = all_reduce(K_ufl @ share(ml, mp), dp)                      # (Mb, D), mp
            mm = all_reduce(torch.sum(ml * ml), dp)
            # A = K_uu/β + K_uf·K_fu (updateAD, CGp.cpp:770-773), by rows
            A_rows = K_uu_rows / beta_m + _ring_gram_rows(K_ufl, mesh, Mb, M)
            L_A_rows, logdet_A = _chol_rows(A_rows, mp, Mb, M)
            v_l = _fwd_solve_rows(L_A_rows, e_l, mp, Mb)
            quad = all_reduce(torch.sum(v_l * v_l), mp)
            Lacc = D * ((M - N) * torch.log(beta) - logdet_uu + logdet_A) - beta * (quad - mm)
            if spec.approx == DTCVAR:
                # D·β·Σ(diag K − diag Q), diag Q from W = L_uu⁻¹K_uf (CGp.cpp:954-955)
                W_l = _fwd_solve_rows(share(L_uu_rows, dp), K_ufl, mp, Mb)
                diagQ = all_reduce(torch.sum(W_l * W_l, dim=0), mp)          # (Nl,), dp
                dD = beta_d * (spec.kern.diag(kp_d, Xl) - diagQ) * maskl
                Lacc = Lacc + D * all_reduce(torch.sum(dD), dp)
        else:
            # FITC (CGp.cpp:806-858, 962-988): D-scaled A in L_uu⁻¹ space
            W_l = _fwd_solve_rows(share(L_uu_rows, dp), K_ufl, mp, Mb)
            diagQ = all_reduce(torch.sum(W_l * W_l, dim=0), mp)
            # padding columns are no-ops: diag D = 1 there
            diagD = torch.where(maskl > 0, 1.0 + beta_d * (spec.kern.diag(kp_d, Xl) - diagQ),
                                torch.ones_like(maskl))
            sDinv = 1.0 / torch.sqrt(diagD)
            scaledM = ml * sDinv[:, None]                                     # dp
            V_l = W_l * share(sDinv, mp)[None, :]                             # mp and dp
            eye_rows = torch.zeros((Mb, M), dtype=V_l.dtype, device=dev).index_put(
                own, torch.ones(Mb, dtype=V_l.dtype, device=dev))
            Am_rows = _ring_gram_rows(V_l, mesh, Mb, M) + eye_rows / beta_m
            L_m_rows, logdet_m = _chol_rows(Am_rows, mp, Mb, M)
            e_l = all_reduce(V_l @ share(scaledM, mp), dp)
            bet_l = _fwd_solve_rows(L_m_rows, e_l, mp, Mb)
            quad_bet = all_reduce(torch.sum(bet_l * bet_l), mp)
            sMsM = all_reduce(torch.sum(scaledM * scaledM), dp)
            logdetD = all_reduce(torch.sum(torch.log(diagD)), dp)
            Lacc = D * ((M - N) * torch.log(beta) + N * ndlutil.LOGTWOPI + logdetD + logdet_m)
            Lacc = Lacc + beta * (sMsM - quad_bet)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
        L = -0.5 * Lacc + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        return -(L - D * N * ndlutil.HALFLOGTWOPI)

    return nlml


def shard_data_2d(mesh: Mesh2D, arr) -> torch.Tensor:
    """This rank's dp row block of a padded array (replicated over mp)."""
    return shard_rows(mesh.dp, arr)


replicated_2d = replicated     # gpc_tpu's name; a Mesh2D has the .device it reads
