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

The dense evidence (`evidence_terms`) has a backward of its own that never
differentiates its factor: the cotangent of A is ḡ_ld·A⁻¹ − ḡ_q·ααᵀ with
α = A⁻¹m, from one explicit A⁻¹ = L⁻ᵀL⁻¹ (`blocked_tri_inv`, then
`tri_gram_lower`), GPc's own pdinv route; zero when the factor is NaN.

Spans (utils/profiling): `gpc.linalg.chol` around the factor,
`gpc.linalg.chol_bwd` around its backward, `gpc.linalg.evidence_bwd`
around the dense evidence's backward, `gpc.linalg.jitter` around the
discovery loop; each blocking read of the device (the factor's `info`, the
finiteness tests, the loop's trace and `info`s) is a `gpc.host_read` span,
counted under `host_read.chol_info`, `host_read.jitchol_finite`,
`host_read.chol_bwd_finite` and `host_read.jitter`.  The counter
`evidence.inverse_vjp` counts the dense evidence's backwards that form A⁻¹.
"""

from __future__ import annotations

import os

import torch
from torch.autograd.function import once_differentiable

from gpc_tpu_torch.ops.chol_blocked import cholesky, evidence_fused
from gpc_tpu_torch.utils.profiling import COUNTS, host_read, span

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
        with span("gpc.linalg.chol"):
            L, info = torch.linalg.cholesky_ex(A)
            with host_read("chol_info"):
                failed = int(info) != 0
            if failed:
                L = torch.full_like(A, float("nan"))
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        with span("gpc.linalg.chol_bwd"):
            (L,) = ctx.saved_tensors
            with host_read("chol_bwd_finite"):
                finite = bool(torch.isfinite(L).all())
            if not finite:
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
    with host_read("jitchol_finite"):
        finite = bool(torch.isfinite(L[-1, -1]))    # a failed factor is NaN throughout
    if finite:
        return L, 0.0
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    with span("gpc.linalg.jitter"), torch.no_grad():
        Asg = A.detach()
        with host_read("jitter"):
            jitter = 1e-6 * float(torch.abs(torch.trace(Asg))) / n
        for _ in range(max_tries):
            _, info = torch.linalg.cholesky_ex(Asg + jitter * eye)
            with host_read("jitter"):
                found = int(info) == 0
            if found:
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


class _DenseEvidence(torch.autograd.Function):
    """(logdet A, Σⱼ mⱼᵀA⁻¹mⱼ, L) with jitchol's escalation; backward
    Ā = ḡ_ld·A⁻¹ − ḡ_q·ααᵀ and m̄ = 2ḡ_q·α, α = A⁻¹m, from one explicit
    A⁻¹ — zero Ā when L is NaN, as _CholNanSafe gives (m̄ is then NaN, as
    the solve's own backward gives).  L is not differentiable."""

    @staticmethod
    def forward(ctx, A, m):
        L, _ = jitchol(A)                   # autograd is off inside forward
        v = tri_solve(L, m)
        ctx.save_for_backward(L, v)
        ctx.mark_non_differentiable(L)
        ctx.set_materialize_grads(False)    # no N × N zeros for L's cotangent
        return chol_logdet(L), torch.sum(v * v), L

    @staticmethod
    @once_differentiable
    def backward(ctx, g_ld, g_q, _):
        with span("gpc.linalg.evidence_bwd"):
            L, v = ctx.saved_tensors
            g_ld = 0.0 if g_ld is None else g_ld                    # an output left unused
            g_q = 0.0 if g_q is None else g_q
            alpha = tri_solve(L, v, trans=True)                     # A⁻¹m
            m_bar = 2.0 * g_q * alpha if ctx.needs_input_grad[1] else None
            if not ctx.needs_input_grad[0]:
                return None, m_bar
            with host_read("chol_bwd_finite"):
                finite = bool(torch.isfinite(L).all())
            if not finite:
                return torch.zeros_like(L), m_bar
            COUNTS["evidence.inverse_vjp"] += 1
            A_bar = tri_gram_lower(blocked_tri_inv(L))              # A⁻¹
            aa = torch.outer(alpha[:, 0], alpha[:, 0])              # ααᵀ by columns,
            for d in range(1, alpha.shape[1]):                      # exactly symmetric
                aa += torch.outer(alpha[:, d], alpha[:, d])
            return A_bar.mul_(g_ld).sub_(aa.mul_(g_q)), m_bar


def evidence_terms(A, m):
    """(logdet A, Σⱼ mⱼᵀA⁻¹mⱼ, L) — the dense FTC evidence block, with the
    closed-form backward of `_DenseEvidence`: gradients reach A and m
    through logdet and the quadratic form only; no gradient flows through
    the returned L.  Under FAST_JITCHOL: the base jitter and one fused
    blocked factor-and-solve sweep (ops/chol_blocked.evidence_fused)."""
    if FAST_JITCHOL:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return evidence_fused(A + _base_jitter(A) * eye, m)
    return _DenseEvidence.apply(A, m)


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


def tri_gram_lower(T: torch.Tensor, block: int = 512) -> torch.Tensor:
    """TᵀT for lower-triangular T, exactly symmetric.  Row block I of the
    lower triangle is T[I:, I]ᵀ·T[I:, :I+1]: one product a row block of at
    most `block` rows, none over a block of T's zero triangle, n³/3 +
    O(n²·block) flops (at n = 16384 on an H100, f32: 33.5 ms at block 512,
    38.0 at 1024, 41.1 at 2048, against 167 for the full product); the
    upper triangle is copied from the lower.  The output is row-major
    whatever T's layout (a factor from cholesky_ex is column-major), so
    elementwise work on it beside row-major operands, as the Gram's VJP
    does, stays coalesced.  With `blocked_tri_inv`: L⁻ᵀL⁻¹ = A⁻¹."""
    n = T.shape[0]
    out = torch.empty(T.shape, dtype=T.dtype, device=T.device)
    for i in range(0, n, block):
        j = min(i + block, n)
        torch.matmul(T[i:, i:j].mT, T[i:, :j], out=out[i:j, :j])
        D = out[i:j, i:j]
        D.copy_(torch.tril(D) + torch.tril(D, -1).mT)
        out[:i, i:j].copy_(out[i:j, :i].mT)
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
