"""Recursive blocked Cholesky with the fused forward solve.

Counterpart of the subset of gpc_tpu/ops/chol_blocked.py that the `lazy`
engine falls back to when N does not split into BASE blocks (or on the CPU
without `force`): the divide-and-conquer factorization

    chol([[A11, ·], [A21, A22]]):
        L11 = chol(A11)
        L21 = A21 · L11⁻ᵀ          (triangular solve, itself recursive)
        L22 = chol(A22 − L21·L21ᵀ)

with the right-hand sides' forward substitution riding the same schedule.
The GEMMs are float32 without TF32 on the card (gpc_tpu_torch turns TF32
off at import), float64 on the CPU; gpc_tpu's bench-era knobs
(GPC_TPU_PALLAS_BASE, GPC_TPU_BF16_CHOL, GPC_TPU_CHOL_PRECISION) are not
ported.
"""

from __future__ import annotations

import torch

BASE = 256  # the leaf block of the recursion and of the lazy engine


def chol(A):
    """Lower Cholesky factor of A, NaN throughout when A is not PD (as
    jnp.linalg.cholesky gives, so a non-PD step reads as a NaN objective);
    no host synchronisation."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, float("nan"))


def _tri_solve_rt(B, L):
    """Solve X·Lᵀ = B for X, L lower-triangular (the L21 panel update),
    recursively so big cases become GEMMs:
        X1·L11ᵀ = B1;  X2·L22ᵀ = B2 − X1·L21ᵀ."""
    n = L.shape[0]
    if n <= BASE:
        return torch.linalg.solve_triangular(L, B.T, upper=False).T
    h = n // 2
    L11, L21, L22 = L[:h, :h], L[h:, :h], L[h:, h:]
    X1 = _tri_solve_rt(B[:, :h], L11)
    X2 = _tri_solve_rt(B[:, h:] - X1 @ L21.T, L22)
    return torch.cat([X1, X2], dim=1)


def _chol_solve_recursive(A, b):
    """chol(A) and v = L⁻¹b in one recursion: the RHS updates b2 − L21·v1
    ride the trailing updates' schedule."""
    n = A.shape[0]
    if n <= BASE:
        L = chol(A)
        return L, torch.linalg.solve_triangular(L, b, upper=False)
    h = n // 2
    A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
    L11, v1 = _chol_solve_recursive(A11, b[:h])
    L21 = _tri_solve_rt(A21, L11)
    L22, v2 = _chol_solve_recursive(A22 - L21 @ L21.T, b[h:] - L21 @ v1)
    top = torch.cat([L11, torch.zeros((h, n - h), dtype=A.dtype, device=A.device)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0), torch.cat([v1, v2], dim=0)


def evidence_fused(K, m, force: bool = False):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ, L) in one fused blocked sweep.  The blocked
    recursion runs with `force` or on the card when N > 2·BASE splits into
    BASE blocks; otherwise one Cholesky and one triangular solve."""
    n = K.shape[-1]
    on_card = K.device.type == "cuda"
    if force or (on_card and n > 2 * BASE and n % BASE == 0):
        L, v = _chol_solve_recursive(K, m)
    else:
        L = chol(K)
        v = torch.linalg.solve_triangular(L, m, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return logdet, torch.sum(v * v), L
