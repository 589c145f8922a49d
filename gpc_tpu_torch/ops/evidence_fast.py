"""Left-looking fused lazy-Gram Cholesky evidence (the `lazy` engine's core).

Counterpart of the product subset of gpc_tpu/ops/evidence_fast.py: the
left-looking blocked factorization of K = kfn(·) where

  * Gram blocks materialize lazily inside the recursion, from a block thunk
    `kfn(i0, j0, bi, bj)` (ops/lazy_evidence.kern_block_fn): no N×N K;
  * every block's correction against ALL its ancestor panels is ONE stacked
    GEMM (`stack`: panels concatenated along the contraction axis);
  * diagonal leaves factor by Cholesky with, under `leafinv`, an explicit
    leaf inverse, so the triangular solves against leaves become GEMMs
    ("pallas": K5, ops/chol_pallas.chol_inv_block; "xla": Cholesky plus a
    triangular solve against the identity; False: Cholesky and triangular
    solves);
  * only (logdet, v = L⁻¹m) survive: L is never assembled.

Policy keeps gpc_tpu's fields base, bf16, leafinv and stack.  Its default
differs in one: bf16=False.  gpc_tpu's bf16 default (bf16-input GEMMs with
f32 accumulation) is its bench setting, which its own docstring calls "NOT
a parity path" (≈ 4e-3 relative error in every Schur update); the port's
default keeps f32 GEMMs without TF32 (f64 on the CPU), so the default
sweep with K5 leaves holds to 2e-4 of the Cholesky leaves
(tests/test_lazy_evidence.py:185-187).  bf16=True stays available,
emulated exactly (bf16-rounded inputs, f32 products).  `prestack` and
`panelhalf`/`evidence_flat` (bench knobs) are not ported.  leafinv=False
and "xla" differentiate; "pallas" is forward only, as in gpc_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpc_tpu_torch.ops.chol_blocked import chol
from gpc_tpu_torch.ops.chol_pallas import chol_inv_block


class Policy(NamedTuple):
    """Precision/schedule settings of the fused evidence sweep."""
    base: int = 256         # leaf block size
    bf16: bool = False      # bf16-input/f32-accumulation corrections and solves
    # leaf inverse: False (Cholesky + triangular solves), "xla" (Cholesky +
    # solve against the identity) or "pallas" (K5); True means "pallas"
    leafinv: object = "pallas"
    stack: bool = True      # one stacked correction GEMM per block


DEFAULT = Policy()


def _mmp(a, b, transpose_b=False, *, bf16):
    """GEMM; the bf16 policy rounds the inputs to bf16 and accumulates in
    float32 (exact products of bf16 values, as the MXU forms them)."""
    if transpose_b:
        b = b.T
    if bf16:
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return a @ b


# A factor is a nested tree:  leaf -> ("leaf", L, inv_or_None)
#                             node -> ("node", left, L21_panel, right)
# L21 panels are stored bf16-rounded under the bf16 policy.

def _leaf(A, b, pol: Policy):
    """Factor one diagonal leaf; returns (tree, v = L⁻¹b, Σ log diag L)."""
    mode = "pallas" if pol.leafinv is True else pol.leafinv
    if mode == "pallas":
        L, M = chol_inv_block(A)
    elif mode == "xla":
        L = chol(A)
        eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        M = torch.linalg.solve_triangular(L, eye, upper=False)
    else:
        L = chol(A)
        return (("leaf", L, None), torch.linalg.solve_triangular(L, b, upper=False),
                torch.sum(torch.log(torch.diagonal(L))))
    return ("leaf", L, M), M @ b, torch.sum(torch.log(torch.diagonal(L)))


def _solve_rt(B, tree, pol: Policy):
    """X·Lᵀ = B against a factor tree; leaf solves are GEMMs when the leaf
    inverse is available."""
    if tree[0] == "leaf":
        _, L, M = tree
        if M is not None:
            return _mmp(B, M, transpose_b=True, bf16=pol.bf16)
        return torch.linalg.solve_triangular(L, B.T, upper=False).T
    _, left, L21, right = tree
    h = L21.shape[1]
    X1 = _solve_rt(B[:, :h], left, pol)
    X2 = _solve_rt(B[:, h:] - _mmp(X1, L21, transpose_b=True, bf16=pol.bf16),
                   right, pol)
    return torch.cat([X1, X2], dim=1)


def _corr(kfn, i0, j0, bi, bj, corr, pol: Policy):
    """Raw K block minus the ancestor corrections.  `corr` entries are
    (panel, row_offset): block (i0, j0) of the current submatrix subtracts
    panel[off+i0 : +bi]·panel[off+j0 : +bj]ᵀ for every ancestor panel; under
    `stack` all ancestors go into ONE GEMM along the contraction axis."""
    A = kfn(i0, j0, bi, bj)
    if not corr:
        return A
    if pol.stack and len(corr) > 1:
        P = torch.cat([p[off + i0:off + i0 + bi] for p, off in corr], dim=1)
        Q = torch.cat([p[off + j0:off + j0 + bj] for p, off in corr], dim=1)
        return A - _mmp(P, Q, transpose_b=True, bf16=pol.bf16)
    for p, off in corr:
        A = A - _mmp(p[off + i0:off + i0 + bi], p[off + j0:off + j0 + bj],
                     transpose_b=True, bf16=pol.bf16)
    return A


def _chol_left(kfn, n, b, corr, pol: Policy):
    """Left-looking fused factor + forward solve + logdet accumulation over
    the submatrix kfn(0.., 0..) of size n."""
    if n <= pol.base:
        return _leaf(_corr(kfn, 0, 0, n, n, corr, pol), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left(kfn, h, b[:h], corr, pol)
    A21 = _corr(kfn, h, 0, n - h, h, corr, pol)
    L21 = _solve_rt(A21, treeL, pol)
    store = L21.to(torch.bfloat16).to(L21.dtype) if pol.bf16 else L21
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple((p, off + h) for p, off in corr) + ((store, 0),)
    treeR, v2, ld2 = _chol_left(
        kfn22, n - h, b[h:] - _mmp(L21, v1, bf16=pol.bf16), corr22, pol)
    return ("node", treeL, store, treeR), torch.cat([v1, v2]), ld1 + ld2


def evidence_left_v(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, v = L⁻¹m) for the lazily materialized SPD K of size n."""
    _tree, v, logdiag = _chol_left(kfn, n, m, (), pol)
    return 2.0 * logdiag, v


def evidence_left_fast(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) for the lazily materialized SPD K of size n;
    `kfn(i0, j0, bi, bj)` returns the raw K block at those offsets."""
    logdet, v = evidence_left_v(kfn, n, m, pol)
    return logdet, torch.sum(v * v)
