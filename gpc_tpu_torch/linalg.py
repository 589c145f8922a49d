"""Positive-definite linear algebra with jitter escalation.

Counterpart of gpc_tpu/linalg.py.  `jitchol` keeps the reference escalation
(CMatrix::jitChol): no jitter first, then 1e-6·mean|diag|, ×10 per retry, up
to `max_tries`; after the last try the factor is NaN, which callers read as
a failed step.  The JAX `lax.cond`/`while_loop` becomes a host loop on
`cholesky_ex`'s `info`.

Gradients: every factor `jitchol` returns comes from `chol_nansafe`, the
counterpart of gpc_tpu's `_chol_nansafe` — the Φ-rule Cholesky backward,
which is a no-op (zero cotangent) when the factor is NaN.  Jitter discovery
runs on a detached copy and builds no graph; the jitter is a plain float, as
gpc_tpu's `stop_gradient` makes it.

GPC_TPU_FAST_JITCHOL=1 (`FAST_JITCHOL`, read once at import, off by
default) is gpc_tpu's fast path: a fixed base jitter 1e-6·mean|diag| and
one factorization through ops/chol_blocked (`cholesky` in `jitchol`, the
fused `evidence_fused` in `evidence_terms`), never the discovery loop.
"""

from __future__ import annotations

import os

import torch

from gpc_tpu_torch.ops.chol_blocked import cholesky, evidence_fused

FAST_JITCHOL = os.environ.get("GPC_TPU_FAST_JITCHOL", "0") == "1"


def _base_jitter(A):
    return 1e-6 * torch.abs(torch.trace(A)) / A.shape[-1]


def _phi_(X):
    """Lower-triangle projection with halved diagonal (Cholesky jvp mask),
    in place on a temporary."""
    X.tril_()
    X.diagonal().mul_(0.5)
    return X


class _CholNanSafe(torch.autograd.Function):
    """L = chol(A), NaN where A is not PD; backward Ā = sym(L⁻ᵀΦ(LᵀL̄)L⁻¹),
    zero when L is NaN (gpc_tpu/linalg.py::_chol_nansafe_bwd)."""

    @staticmethod
    def forward(ctx, A):
        L, info = torch.linalg.cholesky_ex(A)
        if int(info) != 0:
            L = torch.full_like(A, float("nan"))
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        if not bool(torch.isfinite(L).all()):
            return torch.zeros_like(Lbar)
        P = _phi_(L.T @ Lbar)
        D = torch.linalg.solve_triangular(L.T, P, upper=True)          # L⁻ᵀP
        C = torch.linalg.solve_triangular(L.T, D.T, upper=True).T      # L⁻ᵀPL⁻¹
        return 0.5 * (C + C.T)


def chol_nansafe(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A, NaN when A is not PD, with a backward that
    gives a zero (finite) cotangent for a NaN factor."""
    return _CholNanSafe.apply(A)


def jitchol(A: torch.Tensor, max_tries: int = 10):
    """(L, jitter_used): lower Cholesky factor of A with escalating jitter.
    The common case (PD at zero jitter) pays one factorization; otherwise
    the jitter is found on a detached copy and the factor is recomputed once,
    differentiably, at that jitter.  Under FAST_JITCHOL: the base jitter
    and one blocked factorization, whatever it gives."""
    if FAST_JITCHOL:
        jitter = _base_jitter(A)
        return cholesky(A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)), jitter
    L = chol_nansafe(A)
    if bool(torch.isfinite(L[-1, -1])):       # a failed factor is NaN throughout
        return L, 0.0
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    with torch.no_grad():
        Asg = A.detach()
        jitter = 1e-6 * float(torch.abs(torch.trace(Asg))) / n
        for _ in range(max_tries):
            _, info = torch.linalg.cholesky_ex(Asg + jitter * eye)
            if int(info) == 0:
                break
            jitter *= 10.0
        else:
            jitter /= 10.0      # the last jitter tried; its factor is NaN
    return chol_nansafe(A + jitter * eye), jitter


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|A| from its Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))


def tri_solve(L, B, trans: bool = False):
    """L⁻¹ B for lower-triangular L; L⁻ᵀ B with trans=True."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_solve(L, B):
    """A⁻¹ B given the lower Cholesky factor L of A."""
    return torch.cholesky_solve(B, L)


def quad_form(L, m):
    """Σⱼ mⱼᵀA⁻¹mⱼ given the lower Cholesky factor L of A."""
    v = tri_solve(L, m)
    return torch.sum(v * v)


def evidence_terms(A, m):
    """(logdet A, Σⱼ mⱼᵀA⁻¹mⱼ, L) — the dense FTC evidence block.  Under
    FAST_JITCHOL: the base jitter and one fused blocked factor-and-solve
    sweep (ops/chol_blocked.evidence_fused)."""
    if FAST_JITCHOL:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return evidence_fused(A + _base_jitter(A) * eye, m)
    L, _ = jitchol(A)
    return chol_logdet(L), quad_form(L, m), L


def blocked_tri_inv(L: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Dense L⁻¹ (L lower triangular) by recursive block inversion,
    inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹·B·A⁻¹, C⁻¹]], with leaves of at
    most `block` rows.  Serving builds it once so every per-batch variance
    solve is a GEMM."""
    n = L.shape[0]
    if n <= block:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    h = n // 2
    I1 = blocked_tri_inv(L[:h, :h], block)
    I2 = blocked_tri_inv(L[h:, h:], block)
    out = torch.zeros_like(L)
    out[:h, :h] = I1
    out[h:, h:] = I2
    out[h:, :h] = -I2 @ (L[h:, :h] @ I1)
    return out


def pdinv(A):
    """Explicit PD inverse (a parity helper; model code solves with the
    factor instead)."""
    L, _ = jitchol(A)
    inv = chol_solve(L, torch.eye(A.shape[-1], dtype=A.dtype, device=A.device))
    return 0.5 * (inv + inv.T)


def dist2(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances ‖x‖² + ‖x'‖² − 2x·x', ≥ 0, of
    (..., n, q) and (..., m, q) inputs."""
    n1 = torch.sum(X1 * X1, dim=-1, keepdim=True)
    n2 = torch.sum(X2 * X2, dim=-1, keepdim=True)
    return torch.clamp(n1 + n2.mT - 2.0 * (X1 @ X2.mT), min=0.0)
