"""Lazy-Gram fused Cholesky evidence: Gram blocks materialize inside the
factorization (counterpart of gpc_tpu/ops/lazy_evidence.py).

Instead of a dense K the recursions take a block thunk `kfn(i0, j0, bi,
bj)`: each block comes from the kernel's own `compute` on the rows it
needs (K1 or K4 on the card) at its point of first use, with the noise or
white variance on diagonal blocks only.

  * `kern_evidence_lazy` (GPC_TPU_EVIDENCE=lazy, any kernel) runs the
    left-looking recursion of ops/evidence_fast.py on `kern_block_fn`.
    The rank-1 bias term c·𝟙𝟙ᵀ of a cmpnd(·, bias, white) is split off by
    Sherman-Morrison: the factored matrix is K₀ without bias, and 𝟙 rides
    the forward solve as one more column.  The engine differentiates
    (Policy leafinv=False: Cholesky and triangular solves, f32 GEMMs
    without TF32 on the card, f64 on the CPU), as gpc_tpu's always does.
    On the card a call that needs no gradient takes K5 leaves instead
    (leafinv="pallas", gpc_tpu's `Policy()` default): the leaf inverse
    turns the triangular solves against leaves into GEMMs.  gpc_tpu keeps
    Cholesky leaves there too; the two agree to float32 rounding.
  * `rbf_evidence_lazy` (the bench's rbf + noise·I) runs the fully lazy
    left-looking recursion `_chol_solve_left` on `rbf_block_fn`, whose
    blocks are K1 launches on the card; `evidence_fused_lazy` is the
    right-looking `_chol_solve_lazy`, the other schedule gpc_tpu measured.
    Both also assemble L.

gpc_tpu's three switches of kern_evidence_lazy are read once at import:
GPC_TPU_BF16_EVIDENCE=1 (`BF16_EVIDENCE`, bf16-input/f32-accumulation
update GEMMs, off), GPC_TPU_EVIDENCE_PRESTACK=1 (`EVIDENCE_PRESTACK`,
Policy.prestack, off) and GPC_TPU_BIAS_SPLIT=0 (`BIAS_SPLIT`, the rank-1
split, on).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpc_tpu_torch.kernels import Bias, Cmpnd
from gpc_tpu_torch.ops.chol_blocked import (BASE, _base_chol, _blocks, _mm, _tri_solve_rt,
                                            evidence_fused)
from gpc_tpu_torch.ops.chol_pallas import CHOL_MAX
from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_left_fast, evidence_left_v
from gpc_tpu_torch.ops.evidence_mode import evidence_base
from gpc_tpu_torch.ops.gram import dist_gram

BF16_EVIDENCE = os.environ.get("GPC_TPU_BF16_EVIDENCE", "0") == "1"
EVIDENCE_PRESTACK = os.environ.get("GPC_TPU_EVIDENCE_PRESTACK", "0") == "1"
BIAS_SPLIT = os.environ.get("GPC_TPU_BIAS_SPLIT", "1") == "1"


def _chol_solve_lazy(kfn, i0, n, b, A):
    """Fused Cholesky + forward solve over a lazily materialized SPD matrix,
    right-looking: `A` is the trailing matrix once updates have touched it
    (None while raw, when blocks come from kfn at offset i0).  Returns
    (L, v = L⁻¹b, Σ log diag L)."""
    if n <= BASE:
        L = _base_chol(kfn(i0, i0, n, n) if A is None else A)
        return (L, torch.linalg.solve_triangular(L, b, upper=False),
                torch.sum(torch.log(torch.diagonal(L))))
    h = n // 2
    if A is None:
        A11 = A22 = None
        A21 = kfn(i0 + h, i0, n - h, h)
    else:
        A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
    L11, v1, ld1 = _chol_solve_lazy(kfn, i0, h, b[:h], A11)
    L21 = _tri_solve_rt(A21, L11)
    A22 = kfn(i0 + h, i0 + h, n - h, n - h) if A22 is None else A22
    L22, v2, ld2 = _chol_solve_lazy(kfn, i0 + h, n - h, b[h:] - _mm(L21, v1),
                                    A22 - _mm(L21, L21, transpose_b=True))
    return _blocks(L11, L21, L22), torch.cat([v1, v2]), ld1 + ld2


def evidence_fused_lazy(kfn, n, m):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ, L) by the right-looking lazy recursion."""
    L, v, logdiag = _chol_solve_lazy(kfn, 0, n, m, None)
    return 2.0 * logdiag, torch.sum(v * v), L


def rbf_block_fn(X, inv_width, variance, noise):
    """Block thunk of rbf(X) + noise·I, the bench kernel: K1 on the card,
    its plain version on the CPU.  Diagonal elements only appear in blocks
    with i0 == j0 (every recursion splits diagonally), so the ridge goes on
    those alone.  Differentiable in X and the three scalars."""
    params = torch.stack([torch.as_tensor(v, dtype=X.dtype, device=X.device)
                          for v in (inv_width, variance)])

    def kfn(i0, j0, bi, bj):
        K = dist_gram("rbf", params, X[i0:i0 + bi], X[j0:j0 + bj])
        if i0 == j0:
            K = K + noise * torch.eye(bi, dtype=K.dtype, device=K.device)
        return K

    return kfn


def _chol_solve_left(kfn, n, b, corr=()):
    """Fully lazy left-looking variant of `_chol_solve_lazy`: the trailing
    Schur corrections are composed into the block thunk (`corr`, the
    ancestor L21 panels: block (i0, j0) is kfn(i0, j0) − Σ P[i0:]·P[j0:]ᵀ),
    so only lower-triangle blocks of the working matrix ever exist."""

    def block(i0, j0, bi, bj):
        A = kfn(i0, j0, bi, bj)
        for P in corr:
            A = A - _mm(P[i0:i0 + bi], P[j0:j0 + bj], transpose_b=True)
        return A

    if n <= BASE:
        L = _base_chol(block(0, 0, n, n))
        return (L, torch.linalg.solve_triangular(L, b, upper=False),
                torch.sum(torch.log(torch.diagonal(L))))
    h = n // 2
    L11, v1, ld1 = _chol_solve_left(kfn, h, b[:h], corr)
    L21 = _tri_solve_rt(block(h, 0, n - h, h), L11)
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple(P[h:] for P in corr) + (L21,)
    L22, v2, ld2 = _chol_solve_left(kfn22, n - h, b[h:] - _mm(L21, v1), corr22)
    return _blocks(L11, L21, L22), torch.cat([v1, v2]), ld1 + ld2


def evidence_fused_left(kfn, n, m):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ, L) by the fully lazy left-looking
    recursion."""
    L, v, logdiag = _chol_solve_left(kfn, n, m)
    return 2.0 * logdiag, torch.sum(v * v), L


def kern_block_fn(kern, p, X, ridge=0.0):
    """Block thunk for any kernel: K blocks from the kernel's cross compute
    (white-free off the diagonal); a diagonal block's diagonal is the
    kernel's own diag(p, X_b) (which holds the white variance) plus `ridge`,
    as the dense route's gram() overwrites it.  The values are those of
    compute's diagonal plus the white shift, which every kernel of
    kernels.py keeps; the gradient is diag's, finite where compute's is
    not (exp's √(d2 + tiny) at zero distance).  gpc_tpu's lazy engine adds
    the shift to compute's diagonal (a deviation, ROADMAP.md)."""

    def kfn(i0, j0, bi, bj):
        K = kern.compute(p, X[i0:i0 + bi], X[j0:j0 + bj])
        if i0 == j0:
            K = torch.diagonal_scatter(K, kern.diag(p, X[i0:i0 + bi]) + ridge)
        return K

    return kfn


def bias_split(kern):
    """(kern without its bias children, their parameter offsets) when the
    rank-1 split applies — a top-level Cmpnd with at least one Bias child
    and a white/whitefixed child that keeps K₀ positive definite — else
    None."""
    if not isinstance(kern, Cmpnd):
        return None
    idxs = [i for i, c in enumerate(kern.components) if isinstance(c, Bias)]
    if not idxs:
        return None
    rest = tuple(c for c in kern.components if not isinstance(c, Bias))
    if not rest or not any(c.kind in ("white", "whitefixed") for c in rest):
        return None
    off = kern.offsets()
    return dataclasses.replace(kern, components=rest), tuple(off[i] for i in idxs)


def _evidence_bias_split(kern0, slots, p, X, m, ridge, pol):
    """Evidence of K = K₀ + c·𝟙𝟙ᵀ from ONE factorization of K₀ with the
    augmented right-hand side [m | 𝟙]:
      logdet K = logdet K₀ + log(1 + c·s),       s  = 𝟙ᵀK₀⁻¹𝟙,
      mⱼᵀK⁻¹mⱼ = mⱼᵀK₀⁻¹mⱼ − c·uⱼ²/(1 + c·s),  uⱼ = 𝟙ᵀK₀⁻¹mⱼ."""
    n = X.shape[0]
    keep = np.setdiff1d(np.arange(p.shape[0]), np.asarray(slots))
    p0 = p[torch.as_tensor(keep, device=p.device)]
    c = sum(p[s] for s in slots)
    rhs = torch.cat([m, torch.ones((n, 1), dtype=m.dtype, device=m.device)], dim=1)
    logdet0, v = evidence_left_v(kern_block_fn(kern0, p0, X, ridge), n, rhs, pol)
    G = v.T @ v
    s = G[-1, -1]
    u = G[:-1, -1]
    qm = torch.diagonal(G)[:-1]
    denom = 1.0 + c * s
    return logdet0 + torch.log(denom), torch.sum(qm) - c * torch.sum(u * u) / denom


def kern_evidence_lazy(kern, p, X, m, ridge=0.0, force=False):
    """(logdet, quad) for K = kern(X) + ridge·I with the Gram blocks fused
    into the left-looking factorization, when N > 2·base splits into base
    blocks (ops/evidence_mode.evidence_base) and the tensors lie on the card
    (or `force`); otherwise the dense K through the blocked fused sweep of
    ops/chol_blocked.py.  The leaves are K5's on the card when no input
    needs a gradient, Cholesky factors otherwise (module docstring)."""
    n = X.shape[0]
    base = evidence_base()
    if (force or X.device.type == "cuda") and n > 2 * base and n % base == 0:
        needs_grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (p, X, m))
        k5 = X.device.type == "cuda" and not needs_grad and base <= CHOL_MAX
        pol = Policy(base=base, bf16=BF16_EVIDENCE, leafinv="pallas" if k5 else False,
                     stack=True, prestack=EVIDENCE_PRESTACK)
        sp = bias_split(kern) if BIAS_SPLIT else None
        if sp is not None:
            return _evidence_bias_split(sp[0], sp[1], p, X, m, ridge, pol)
        return evidence_left_fast(kern_block_fn(kern, p, X, ridge), n, m, pol)
    K = kern.compute(p, X, X)
    K = torch.diagonal_scatter(K, K.diagonal() + (kern.white(p) + ridge))
    logdet, quad, _L = evidence_fused(K, m, force=force)
    return logdet, quad


def rbf_evidence_lazy(X, m, inv_width, variance, noise, force=False):
    """(logdet, quad) of K = rbf(X) + noise·I with the Gram blocks fused
    into the fully lazy left-looking recursion, when N > 2·BASE splits into
    BASE blocks and X lies on the card (or `force`); otherwise the dense K
    through the fused sweep of ops/chol_blocked.py."""
    n = X.shape[0]
    kfn = rbf_block_fn(X, inv_width, variance, noise)
    if (force or X.device.type == "cuda") and n > 2 * BASE and n % BASE == 0:
        logdet, quad, _L = evidence_fused_left(kfn, n, m)
    else:
        logdet, quad, _L = evidence_fused(kfn(0, 0, n, n), m, force=force)
    return logdet, quad
