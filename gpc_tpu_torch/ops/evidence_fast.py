"""Left-looking fused lazy-Gram Cholesky evidence: the `lazy` engine's core.

Counterpart of gpc_tpu/ops/evidence_fast.py: the left-looking blocked
factorization of K = kfn(·) where

  * Gram blocks materialize lazily inside the recursion, from a block thunk
    `kfn(i0, j0, bi, bj)` (ops/lazy_evidence.kern_block_fn): no N×N K;
  * every block's correction against ALL its ancestor panels is ONE stacked
    GEMM (panels concatenated along the contraction axis);
  * diagonal leaves factor by Cholesky and, under leafinv="pallas", come
    with their inverse from K5 (ops/chol_pallas.chol_inv_block), so the
    triangular solves against leaves become GEMMs; under leafinv=False
    they stay Cholesky factors and triangular solves;
  * only (logdet, v = L⁻¹m) survive: L is never assembled.

The GEMMs are float32 without TF32 on the card (f64 on the CPU); the sweep
with K5 leaves holds to 2e-4 of the Cholesky leaves
(tests/test_lazy_evidence.py:185-187).  leafinv=False differentiates;
"pallas" is forward only, as in gpc_tpu.  Policy keeps the two of
gpc_tpu's fields that the lazy engine sets (base, leafinv) with the same
meaning; stacked f32 corrections are what gpc_tpu's stack=True, bf16=False
computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpc_tpu_torch.ops.chol_pallas import chol_inv_block


class Policy(NamedTuple):
    """Leaf settings of the fused evidence sweep."""
    base: int = 256         # leaf block size
    # leaf inverse: False (Cholesky + triangular solves) or "pallas" (K5)
    leafinv: object = "pallas"


DEFAULT = Policy()


def chol(A):
    """Lower Cholesky factor of A, NaN throughout when A is not PD (as
    jnp.linalg.cholesky gives, so a non-PD step reads as a NaN objective);
    no host synchronisation."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, float("nan"))


# A factor is a nested tree:  leaf -> ("leaf", L, inv_or_None)
#                             node -> ("node", left, L21_panel, right)

def _leaf(A, b, pol: Policy):
    """Factor one diagonal leaf; returns (tree, v = L⁻¹b, Σ log diag L)."""
    if pol.leafinv == "pallas":
        L, M = chol_inv_block(A.contiguous())     # K5 takes a contiguous block
        return ("leaf", L, M), M @ b, torch.sum(torch.log(torch.diagonal(L)))
    L = chol(A)
    return (("leaf", L, None), torch.linalg.solve_triangular(L, b, upper=False),
            torch.sum(torch.log(torch.diagonal(L))))


def _solve_rt(B, tree):
    """X·Lᵀ = B against a factor tree; leaf solves are GEMMs when the leaf
    inverse is available."""
    if tree[0] == "leaf":
        _, L, M = tree
        if M is not None:
            return B @ M.T
        return torch.linalg.solve_triangular(L, B.T, upper=False).T
    _, left, L21, right = tree
    h = L21.shape[1]
    X1 = _solve_rt(B[:, :h], left)
    X2 = _solve_rt(B[:, h:] - X1 @ L21.T, right)
    return torch.cat([X1, X2], dim=1)


def _corr(kfn, i0, j0, bi, bj, corr):
    """Raw K block minus the ancestor corrections.  `corr` entries are
    (panel, row_offset): block (i0, j0) of the current submatrix subtracts
    panel[off+i0 : +bi]·panel[off+j0 : +bj]ᵀ for every ancestor panel, all
    of them in ONE GEMM along the contraction axis."""
    A = kfn(i0, j0, bi, bj)
    if not corr:
        return A
    P = torch.cat([p[off + i0:off + i0 + bi] for p, off in corr], dim=1)
    Q = torch.cat([p[off + j0:off + j0 + bj] for p, off in corr], dim=1)
    return A - P @ Q.T


def _chol_left(kfn, n, b, corr, pol: Policy):
    """Left-looking fused factor + forward solve + logdet accumulation over
    the submatrix kfn(0.., 0..) of size n."""
    if n <= pol.base:
        return _leaf(_corr(kfn, 0, 0, n, n, corr), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left(kfn, h, b[:h], corr, pol)
    L21 = _solve_rt(_corr(kfn, h, 0, n - h, h, corr), treeL)
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple((p, off + h) for p, off in corr) + ((L21, 0),)
    treeR, v2, ld2 = _chol_left(kfn22, n - h, b[h:] - L21 @ v1, corr22, pol)
    return ("node", treeL, L21, treeR), torch.cat([v1, v2]), ld1 + ld2


def evidence_left_v(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, v = L⁻¹m) for the lazily materialized SPD K of size n;
    callers that need cross terms between right-hand sides (the rank-1 bias
    split of ops/lazy_evidence.py) get the whole forward-solved block."""
    _tree, v, logdiag = _chol_left(kfn, n, m, (), pol)
    return 2.0 * logdiag, v


def evidence_left_fast(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) for the lazily materialized SPD K of size n;
    `kfn(i0, j0, bi, bj)` returns the raw K block at those offsets."""
    logdet, v = evidence_left_v(kfn, n, m, pol)
    return logdet, torch.sum(v * v)
