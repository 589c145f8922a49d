"""Left-looking fused lazy-Gram Cholesky evidence (the `lazy` engine's core
and gpc_tpu's bench evidence engines).

Counterpart of gpc_tpu/ops/evidence_fast.py: the left-looking blocked
factorization of K = kfn(·) where

  * Gram blocks materialize lazily inside the recursion, from a block thunk
    `kfn(i0, j0, bi, bj)` (ops/lazy_evidence.kern_block_fn, rbf_block_fn):
    no N×N K;
  * every block's correction against ALL its ancestor panels is ONE stacked
    GEMM (`stack`: panels concatenated along the contraction axis; under
    `prestack` the ancestors are concatenated once a recursion node and
    each block reads row slices of that array);
  * diagonal leaves factor by Cholesky with, under `leafinv`, an explicit
    leaf inverse, so the triangular solves against leaves become GEMMs
    ("pallas": K5, ops/chol_pallas.chol_inv_block; "xla": Cholesky plus a
    triangular solve against the identity; False: Cholesky and triangular
    solves);
  * only (logdet, v = L⁻¹m) survive: L is never assembled.

`evidence_flat` is the other schedule: one (n, n) buffer of finished
columns and, per column of `base` rows, one leaf, one tall correction GEMM
and one panel solve.

Policy keeps gpc_tpu's fields.  Its default differs in one: bf16=False.
gpc_tpu's bf16 default (bf16-input GEMMs with f32 accumulation) is its
bench setting, which its own docstring calls "NOT a parity path" (≈ 4e-3
relative error in every Schur update); the port's default keeps f32 GEMMs
without TF32 (f64 on the CPU), so the default sweep with K5 leaves holds
to 2e-4 of the Cholesky leaves (tests/test_lazy_evidence.py:185-187).
bf16=True is emulated exactly (`_mmp`: bf16-rounded inputs, f32 products).
leafinv=False and "xla" differentiate; "pallas" is forward only, as in
gpc_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpc_tpu_torch.ops.chol_blocked import _mmp, chol
from gpc_tpu_torch.ops.chol_pallas import chol_inv_block


class Policy(NamedTuple):
    """Precision/schedule settings of the fused evidence sweep."""
    base: int = 256         # leaf block size
    bf16: bool = False      # bf16-input/f32-accumulation corrections and solves
    # leaf inverse: False (Cholesky + triangular solves), "xla" (Cholesky +
    # solve against the identity) or "pallas" (K5); True means "pallas"
    leafinv: object = "pallas"
    stack: bool = True      # one stacked correction GEMM per block
    # prestack: the ancestor panels concatenated once a recursion node, each
    # block's correction a GEMM on row slices of that array (implies stack)
    prestack: bool = False
    # panelhalf (evidence_flat only): round the corrected panel R to bf16
    # before its solve (gpc_tpu measured ~10x the drift of plain bf16)
    panelhalf: bool = False


DEFAULT = Policy()


# A factor is a nested tree:  leaf -> ("leaf", L, inv_or_None)
#                             node -> ("node", left, L21_panel, right)
# L21 panels are stored bf16-rounded under the bf16 policy.

def _leaf(A, b, pol: Policy):
    """Factor one diagonal leaf; returns (tree, v = L⁻¹b, Σ log diag L)."""
    mode = "pallas" if pol.leafinv is True else pol.leafinv
    if mode == "pallas":
        L, M = chol_inv_block(A.contiguous())     # K5 takes a contiguous block
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


def _store(L21, pol: Policy):
    """A finished panel as later corrections read it: bf16-rounded under
    the bf16 policy."""
    return L21.to(torch.bfloat16).to(L21.dtype) if pol.bf16 else L21


def _chol_left(kfn, n, b, corr, pol: Policy):
    """Left-looking fused factor + forward solve + logdet accumulation over
    the submatrix kfn(0.., 0..) of size n."""
    if n <= pol.base:
        return _leaf(_corr(kfn, 0, 0, n, n, corr, pol), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left(kfn, h, b[:h], corr, pol)
    A21 = _corr(kfn, h, 0, n - h, h, corr, pol)
    L21 = _solve_rt(A21, treeL, pol)
    store = _store(L21, pol)
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple((p, off + h) for p, off in corr) + ((store, 0),)
    treeR, v2, ld2 = _chol_left(
        kfn22, n - h, b[h:] - _mmp(L21, v1, bf16=pol.bf16), corr22, pol)
    return ("node", treeL, store, treeR), torch.cat([v1, v2]), ld1 + ld2


def _corr_pre(kfn, i0, j0, bi, bj, C, off, pol: Policy):
    """Raw K block minus the corrections read from ONE prestacked array C,
    whose row off + i is the current submatrix's row i: one GEMM on plain
    row slices, no per-block concatenation."""
    A = kfn(i0, j0, bi, bj)
    if C is None:
        return A
    return A - _mmp(C[off + i0:off + i0 + bi], C[off + j0:off + j0 + bj],
                    transpose_b=True, bf16=pol.bf16)


def _chol_left_pre(kfn, n, b, C, off, pol: Policy):
    """`_chol_left` under Policy.prestack: the right subtree's correction
    array is the parent's rows with the fresh L21 panel beside them, built
    once a node instead of once a block."""
    if n <= pol.base:
        return _leaf(_corr_pre(kfn, 0, 0, n, n, C, off, pol), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left_pre(kfn, h, b[:h], C, off, pol)
    L21 = _solve_rt(_corr_pre(kfn, h, 0, n - h, h, C, off, pol), treeL, pol)
    store = _store(L21, pol)
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    C22 = store if C is None else torch.cat([C[off + h:off + n], store], dim=1)
    treeR, v2, ld2 = _chol_left_pre(
        kfn22, n - h, b[h:] - _mmp(L21, v1, bf16=pol.bf16), C22, 0, pol)
    return ("node", treeL, store, treeR), torch.cat([v1, v2]), ld1 + ld2


def evidence_flat(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) by the flat left-looking schedule over the
    finished columns of L (bf16 under the bf16 policy):

      per column j of b = pol.base rows, jb = j·b:
          Vj   = L[jb:jb+b, :jb]                   (this row's panel)
          A    = K(j, j) − Vj·Vjᵀ;  leaf (L_jj, L_jj⁻¹ under leafinv)
          v_j  = L_jj⁻¹·(m_j − Vj·v[:jb])
          R    = K(below, j) − L[jb+b:, :jb]·Vjᵀ   (ONE tall GEMM)
          L[jb+b:, jb:jb+b] ← R·L_jj⁻ᵀ            (bf16 R under panelhalf)

    Without a gradient the columns land in place in one (n, n) buffer and
    the GEMMs read strided slices of it (gpc_tpu's dynamic_update_slice,
    which XLA does in place).  When the blocks or m need a gradient, an
    in-place write would overwrite tensors that autograd saved, so each
    finished column panel is kept as its own tensor and a correction reads
    their rows concatenated.  Differentiable for leafinv in (False, "xla")."""
    b = pol.base
    nb = n // b
    if n % b or nb < 2:
        raise ValueError(f"evidence_flat: n = {n} must be a multiple of base = {b}, "
                         "at least twice it")
    store_dt = torch.bfloat16 if pol.bf16 else m.dtype
    A = kfn(0, 0, b, b)
    in_place = not (torch.is_grad_enabled() and (A.requires_grad or m.requires_grad))
    Lbuf = torch.zeros((n, n), dtype=store_dt, device=m.device) if in_place else None
    panels = []        # without Lbuf: panel k holds rows (k+1)·b .. n of column k

    def finished(r0, r1, j):
        """L[r0:r1, :j·b]."""
        if in_place:
            return Lbuf[r0:r1, :j * b]
        return torch.cat([P[r0 - (k + 1) * b:r1 - (k + 1) * b]
                          for k, P in enumerate(panels)], dim=1)

    vs = []
    logdet = torch.zeros((), dtype=m.dtype, device=m.device)
    for j in range(nb):
        jb = j * b
        wj = m[jb:jb + b]
        if j > 0:
            A = kfn(jb, jb, b, b)
            Vj = finished(jb, jb + b, j)
            A = A - _mmp(Vj, Vj, transpose_b=True, bf16=pol.bf16)
            wj = wj - _mmp(Vj, torch.cat(vs), bf16=pol.bf16)
        (_, Lx, M), v_j, ld_j = _leaf(A, wj, pol)
        vs.append(v_j)
        logdet = logdet + ld_j
        if j + 1 == nb:
            break
        R = kfn(jb + b, jb, n - jb - b, b)
        if j > 0:
            R = R - _mmp(finished(jb + b, n, j), Vj, transpose_b=True, bf16=pol.bf16)
        if pol.bf16 and pol.panelhalf:
            R = R.to(torch.bfloat16)
        if M is not None:
            L21 = _mmp(R, M, transpose_b=True, bf16=pol.bf16)
        else:
            L21 = torch.linalg.solve_triangular(Lx, R.to(Lx.dtype).T, upper=False).T
        if in_place:
            Lbuf[jb + b:, jb:jb + b] = L21
        else:
            panels.append(L21.to(store_dt))
    v = torch.cat(vs)
    return 2.0 * logdet, torch.sum(v * v)


def evidence_left_v(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, v = L⁻¹m) for the lazily materialized SPD K of size n;
    callers that need cross terms between right-hand sides (the rank-1 bias
    split of ops/lazy_evidence.py) get the whole forward-solved block."""
    if pol.prestack:
        _tree, v, logdiag = _chol_left_pre(kfn, n, m, None, 0, pol)
    else:
        _tree, v, logdiag = _chol_left(kfn, n, m, (), pol)
    return 2.0 * logdiag, v


def evidence_left_fast(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) for the lazily materialized SPD K of size n;
    `kfn(i0, j0, bi, bj)` returns the raw K block at those offsets."""
    logdet, v = evidence_left_v(kfn, n, m, pol)
    return logdet, torch.sum(v * v)
