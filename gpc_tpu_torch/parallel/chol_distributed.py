"""Distributed right-looking blocked Cholesky over a row-block-sharded K
(counterpart of gpc_tpu/parallel/chol_distributed.py).

Rank d holds the row block K[d·B:(d+1)·B, :], so no rank holds an N × N
object: memory is O(N·B), B = N / world.  The panel sweep, W = B columns a
panel and one panel a rank:

  for j in 0..world-1:
    1. every rank contributes its B × B slice of column panel j; one
       all_gather assembles the (N, B) panel, the only communication
       (N·B numbers a step, N² in all);
    2. replicated work: L_jj = chol(panel[jB:(j+1)B]), and the rows below
       it L_panel = panel·L_jj⁻ᵀ (rows above the block are final);
    3. each rank below the panel updates its trailing columns with one
       local GEMM, S[:, k > jB] −= L_mine·L_panel[k rows]ᵀ;
    4. each rank writes its rows of the finished panel into its block.

The factor comes back row-sharded.  `chol_distributed` is the raw factor;
`evidence_distributed` is the differentiable surface, a torch.autograd
Function whose forward fuses the factorization with the forward solve
L·v = m and the logdet, and whose backward runs the reverse sweeps.

As in gpc_tpu there is no jitter rescue inside the sweep: a block that is
not positive definite gives a NaN factor, so a NaN evidence that SCG
rejects as a failed step (the dense single-process route re-jitters).

The gradient discipline is dist_gp.py's: each gathered panel is
replicated, and where it enters this rank's rows it passes through
`share`, so the same code runs differentiably (the 2-D sparse mesh
differentiates through it) and, under no_grad, as the raw sweep.
"""

from __future__ import annotations

import torch

from gpc_tpu_torch.parallel.dist_gp import all_gather_rows, share
from gpc_tpu_torch.parallel.mesh import Mesh, gather_rows


def _chol_or_nan(A):
    """Lower Cholesky factor of A, NaN throughout where A is not PD (no host
    sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _local_factor_step(j: int, S_local, mesh: Mesh, B: int):
    """Panel step j on this rank's (B, N) rows S_local over the axis `mesh`
    (the data axis of the dense paths, the mp axis of the 2-D sparse mesh).
    Returns (the new rows, the replicated (N, B) factor panel j)."""
    d = mesh.rank
    lo, hi = j * B, (j + 1) * B
    panel = all_gather_rows(S_local[:, lo:hi], mesh)              # (N, B) replicated
    L_jj = _chol_or_nan(panel[lo:hi])
    # the rows below the diagonal block: panel·L_jj⁻ᵀ
    below = torch.linalg.solve_triangular(L_jj.mT, panel[hi:], upper=True, left=False)
    L_panel = torch.cat([torch.zeros_like(panel[:lo]), L_jj, below])
    L_loc = share(L_panel, mesh)
    L_mine = L_loc[d * B:(d + 1) * B]
    # every rank runs the update (the ranks above the panel have zero rows
    # in it, and the panel's own rank writes only its upper triangle, which
    # nothing reads): the same graph on every rank, so the backward's
    # collectives run in the same order on all of them (dist_gp.py)
    trailing = S_local[:, hi:] - L_mine @ L_loc[hi:].mT
    return torch.cat([S_local[:, :lo], L_mine, trailing], dim=1), L_panel


def _gather_panel(L_local, j: int, B: int, mesh: Mesh):
    """The replicated (N, B) column panel j of the row-sharded factor."""
    return gather_rows(mesh, L_local[:, j * B:(j + 1) * B])


def _forward_step(panel, r, j: int, B: int):
    """One step of L·v = r on the replicated panel j: v_j into r's rows of
    block j, the rows below updated (in place; no autograd)."""
    lo, hi = j * B, (j + 1) * B
    v_j = torch.linalg.solve_triangular(panel[lo:hi], r[lo:hi], upper=False)
    r[hi:] -= panel[hi:] @ v_j
    r[lo:hi] = v_j


def _forward_solve_sweep(L_local, r, mesh: Mesh, B: int):
    """Forward substitution L·v = r over the gathered panels (r replicated
    or this rank's own; returns a new tensor)."""
    r = r.clone()
    for j in range(mesh.size):
        _forward_step(_gather_panel(L_local, j, B, mesh), r, j, B)
    return r


def _backward_solve_sweep(L_local, v, mesh: Mesh, B: int):
    """Backward substitution Lᵀ·a = v over the gathered panels (returns a
    new tensor)."""
    a = v.clone()
    for j in reversed(range(mesh.size)):
        lo, hi = j * B, (j + 1) * B
        panel = _gather_panel(L_local, j, B, mesh)
        rhs = a[lo:hi] - panel[hi:].mT @ a[hi:]
        a[lo:hi] = torch.linalg.solve_triangular(panel[lo:hi].mT, rhs, upper=True)
    return a


def _factor_solve_sweep(S_local, R, mesh: Mesh, B: int):
    """The fused sweep, no autograd: the factor's rows, V = L⁻¹R
    (R replicated) and logdet K, replicated."""
    V = R.clone()
    logdet = torch.zeros((), dtype=S_local.dtype, device=S_local.device)
    for j in range(mesh.size):
        S_local, panel = _local_factor_step(j, S_local, mesh, B)
        _forward_step(panel, V, j, B)
        logdet = logdet + 2.0 * torch.sum(torch.log(torch.diagonal(panel[j * B:(j + 1) * B])))
    return S_local, V, logdet


class _Evidence(torch.autograd.Function):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) of the row-sharded K and the replicated m.

    Backward (CGp::updateCovGradient, CGp.cpp:666-679): with α = K⁻¹m,
    ∂logdet/∂K = K⁻¹ and ∂quad/∂K = −α·αᵀ, so this rank's rows of K̄ are
    g_ld·Zᵀ − g_quad·α_mine·αᵀ with Z = K⁻¹E_d (E_d: this rank's unit
    columns), and m̄ = 2·g_quad·α (replicated, as m is).  α and Z come from
    one forward sweep of E_d and one backward sweep of [v | L⁻¹E_d]."""

    @staticmethod
    def forward(ctx, K_rows, m, mesh):
        L_local, v, logdet = _factor_solve_sweep(K_rows, m, mesh, K_rows.shape[0])
        ctx.mesh = mesh
        ctx.save_for_backward(L_local, v)
        return logdet, torch.sum(v * v)

    @staticmethod
    def backward(ctx, g_ld, g_quad):
        L_local, v = ctx.saved_tensors
        mesh = ctx.mesh
        B, N = L_local.shape
        D = v.shape[1]
        rows = mesh.rank * B + torch.arange(B, device=v.device)
        U0 = torch.zeros((N, B), dtype=v.dtype, device=v.device)
        U0[rows, torch.arange(B, device=v.device)] = 1.0
        W = _forward_solve_sweep(L_local, U0, mesh, B)
        sol = _backward_solve_sweep(L_local, torch.cat([v, W], dim=1), mesh, B)
        alpha, Z = sol[:, :D], sol[:, D:]
        Kbar = g_ld * Z.mT - g_quad * (alpha[rows] @ alpha.mT)
        return Kbar, 2.0 * g_quad * alpha, None


def evidence_distributed(mesh: Mesh, K_rows, m):
    """logdet K and Σⱼ mⱼᵀK⁻¹mⱼ from one fused panel sweep, differentiable
    in (K_rows, m): K_rows this rank's (N/world, N) rows of K, m the
    replicated (N, D) right-hand sides (the all-gather of the row blocks,
    `dist_gp.all_gather_rows`, whose backward takes this rank's block).
    Returns the replicated 0-d (logdet, quad); no rank holds an N × N
    object.  The backward all-gathers each factor panel twice more."""
    N = K_rows.shape[1]
    if N % mesh.size or K_rows.shape[0] * mesh.size != N:
        raise ValueError(f"evidence_distributed: K_rows {tuple(K_rows.shape)} is not one of "
                         f"{mesh.size} equal row blocks of an N x N matrix")
    return _Evidence.apply(K_rows, m, mesh)


def chol_distributed(mesh: Mesh, K_rows):
    """The row-sharded lower Cholesky factor of the row-sharded SPD K:
    K_rows this rank's (N/world, N) rows; N must divide by the world size.
    Forward only."""
    B, N = K_rows.shape
    if B * mesh.size != N:
        raise ValueError(f"chol_distributed: {B} rows a rank over {mesh.size} ranks "
                         f"is not N = {N}")
    with torch.no_grad():
        S = K_rows
        for j in range(mesh.size):
            S, _ = _local_factor_step(j, S, mesh, B)
        rows = mesh.rank * B + torch.arange(B, device=S.device)[:, None]
        return torch.where(torch.arange(N, device=S.device)[None, :] <= rows, S, 0.0)
