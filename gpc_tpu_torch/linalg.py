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

import torch
from torch.autograd.function import once_differentiable

from gpc_tpu_torch.utils.profiling import COUNTS, host_read, span


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
    differentiably, at that jitter."""
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
    the returned L."""
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


def _blocks(M, count, rows, cols, r0, c0, step_r, step_c):
    """`count` blocks M[r0 + i·step_r :+rows, c0 + i·step_c :+cols] of a 2-D
    tensor as one strided batch view (no copy), whatever M's layout."""
    s0, s1 = M.stride()
    return M.as_strided((count, rows, cols), (step_r * s0 + step_c * s1, s0, s1),
                        M.storage_offset() + r0 * s0 + c0 * s1)


def tri_apply(Linv: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Linv·B for lower-triangular Linv (n × n) and B (n × t), reading and
    multiplying Linv's lower triangle alone: n²t + O(n·b·t) flops and
    about n²/2 of Linv's entries, against 2n²t and n² for the full
    product.  Leaves of b = 128 rows: the lower triangles of the m = n // b
    diagonal blocks in one batched product; then, by levels of nodes
    of s = 2, 4, … blocks, the block under each node's diagonal (its lower
    half's rows, its upper half's columns) added in by one batched product
    a level over the whole nodes, and one product for a node cut short at
    row m·b; the last n − m·b rows one product over their lower triangle.  Every product writes into one preallocated output; the
    skipped entries are exact zeros, so only the summation order differs
    from Linv @ B.

    Measured at n = 16384 on an H100, f32, Linv column-major: leaves of 64,
    128 and 256 rows are within 2 % of each other at every t from 1 to
    8192, larger ones slower at every t, so the leaf does not follow t.
    What does: at t ≤ 128 the product is bound by Linv's bytes, and
    cuBLAS's batched kernels read them at ≈ 0.9 TB/s where one product
    over one node reads 2.2 TB/s, so levels of at most two nodes go node
    by node (t = 2 to 32: 0.41 ms against 0.48 batched and 0.45 for Linv @
    B; 0.5–1.6 % slower than batched from t = 256 on).  43.3 ms at t =
    8192, 5.49 at t = 1024 against 81.4 and 10.37 for Linv @ B."""
    n, t = B.shape
    b = 128
    out = torch.empty((n, t), dtype=B.dtype, device=B.device)
    m = n // b
    e = m * b
    if m:
        torch.bmm(torch.tril(_blocks(Linv, m, b, b, 0, 0, b, b)), _blocks(B, m, b, t, 0, 0, b, 0),
                  out=_blocks(out, m, b, t, 0, 0, b, 0))
    s = 2
    while s // 2 < m:
        S, h = s * b, s // 2 * b          # a node's rows, its halves' rows
        k = m // s                        # whole nodes
        few = t <= 128 and k <= 2         # then node by node
        if k and not few:
            _blocks(out, k, h, t, h, 0, S, 0).baddbmm_(
                _blocks(Linv, k, h, h, h, 0, S, S), _blocks(B, k, h, t, 0, 0, S, 0))
        for i in range(0 if few else k, k + 1):     # and the node cut short at row e
            r0, r1 = i * S + h, min(i * S + S, e)
            if r0 < r1:
                out[r0:r1].addmm_(Linv[r0:r1, i * S:r0], B[i * S:r0])
        s *= 2
    if e < n:
        torch.matmul(torch.tril(Linv[e:], diagonal=e), B, out=out[e:])
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
