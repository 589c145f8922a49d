"""Recursive blocked Cholesky and triangular solve, with the fused forward
solve (counterpart of gpc_tpu/ops/chol_blocked.py).

The divide-and-conquer factorization

    chol([[A11, ·], [A21, A22]]):
        L11 = chol(A11)
        L21 = A21 · L11⁻ᵀ          (triangular solve, itself recursive)
        L22 = chol(A22 − L21·L21ᵀ)

puts almost all of its work into large GEMMs.  `cholesky(A)` takes it on
the card when N > 2·BASE splits into BASE blocks (gpc_tpu takes it on its
accelerator) and one `chol` everywhere else; `evidence_fused` lets the
right-hand sides' forward substitution ride the same schedule.  The GEMMs
are float32 without TF32 on the card (gpc_tpu_torch turns TF32 off at
import), float64 on the CPU.

Two of gpc_tpu's switches are ported, read once at import and off by
default:

  * GPC_TPU_BF16_CHOL=1 (`BF16_UPDATES`): the float32 update GEMMs take
    bf16-rounded inputs and sum the exact products in float32 (`_mmp`, the
    emulation the bf16 policy of ops/evidence_fast.py uses too);
  * GPC_TPU_PALLAS_BASE=1 (`PALLAS_BASE`): every BASE leaf is factored with
    its inverse (K5, ops/chol_pallas.chol_inv_block, on the card; its plain
    version on the CPU), so every triangular solve against a leaf is a
    GEMM.  Forward only on the card, as gpc_tpu's.

gpc_tpu's GPC_TPU_CHOL_PRECISION is not ported: it counts the TPU's bf16
matrix-unit passes, and torch's same-named "high" means TF32, which is less
precise than the TPU's three-pass bf16, so the port keeps full float32.
"""

from __future__ import annotations

import os

import torch

from gpc_tpu_torch.ops.chol_pallas import chol_inv_block

BASE = 256  # the leaf block of the recursion and of the lazy engine

BF16_UPDATES = os.environ.get("GPC_TPU_BF16_CHOL", "0") == "1"
PALLAS_BASE = os.environ.get("GPC_TPU_PALLAS_BASE", "0") == "1"


def _mmp(a, b, transpose_b=False, *, bf16):
    """GEMM; the bf16 policy rounds the inputs to bf16 and accumulates in
    float32 (exact products of bf16 values, as the MXU forms them)."""
    if transpose_b:
        b = b.T
    if bf16:
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return a @ b


def _mm(a, b, transpose_b=False):
    """The recursion's update GEMM: bf16 inputs under BF16_UPDATES for
    float32 operands, else in the operands' dtype."""
    return _mmp(a, b, transpose_b, bf16=BF16_UPDATES and a.dtype == torch.float32)


def chol(A):
    """Lower Cholesky factor of A, NaN throughout when A is not PD (as
    jnp.linalg.cholesky gives, so a non-PD step reads as a NaN objective);
    no host synchronisation."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, float("nan"))


def _blocks(L11, L21, L22):
    """[[L11, 0], [L21, L22]]."""
    h, n = L11.shape[0], L11.shape[0] + L22.shape[0]
    top = torch.cat([L11, torch.zeros((h, n - h), dtype=L11.dtype, device=L11.device)], dim=1)
    return torch.cat([top, torch.cat([L21, L22], dim=1)], dim=0)


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
    X2 = _tri_solve_rt(B[:, h:] - _mm(X1, L21, transpose_b=True), L22)
    return torch.cat([X1, X2], dim=1)


def _base_chol(A):
    """The leaf factorization (gpc_tpu keeps XLA's Cholesky here too)."""
    return chol(A)


def _chol_recursive(A):
    n = A.shape[0]
    if n <= BASE:
        return _base_chol(A)
    h = n // 2
    L11 = _chol_recursive(A[:h, :h])
    L21 = _tri_solve_rt(A[h:, :h], L11)
    L22 = _chol_recursive(A[h:, h:] - _mm(L21, L21, transpose_b=True))
    return _blocks(L11, L21, L22)


def _blocked(n, on_card, force):
    return force or (on_card and n > 2 * BASE and n % BASE == 0)


def cholesky(A, force: bool = False):
    """Lower Cholesky factor of A (NaN where A is not PD): the recursive
    blocked path with `force` or on the card when N > 2·BASE splits into
    BASE blocks (the leaf-inverse recursion under PALLAS_BASE), one `chol`
    otherwise."""
    return _cholesky(A, force, PALLAS_BASE)


def _cholesky(A, force: bool, leafinv: bool):
    """`cholesky` with the leaf-inverse recursion chosen by the caller."""
    n = A.shape[-1]
    if A.dim() == 2 and _blocked(n, A.device.type == "cuda", force):
        if leafinv:
            zero = torch.zeros((n, 1), dtype=A.dtype, device=A.device)
            return _chol_solve_leafinv(A, zero)[0]
        return _chol_recursive(A)
    return chol(A)


def _chol_solve_recursive(A, b):
    """chol(A) and v = L⁻¹b in one recursion: the RHS updates b2 − L21·v1
    ride the trailing updates' schedule."""
    n = A.shape[0]
    if n <= BASE:
        L = _base_chol(A)
        return L, torch.linalg.solve_triangular(L, b, upper=False)
    h = n // 2
    L11, v1 = _chol_solve_recursive(A[:h, :h], b[:h])
    L21 = _tri_solve_rt(A[h:, :h], L11)
    L22, v2 = _chol_solve_recursive(A[h:, h:] - _mm(L21, L21, transpose_b=True),
                                    b[h:] - _mm(L21, v1))
    return _blocks(L11, L21, L22), torch.cat([v1, v2], dim=0)


def _solve_rt_leafinv(B, L, inv):
    """X·Lᵀ = B with `inv` the nested tuple of L's leaf-block inverses."""
    n = L.shape[0]
    if n <= BASE:
        return _mm(B, inv, transpose_b=True)          # X = B·L⁻ᵀ
    h = n // 2
    X1 = _solve_rt_leafinv(B[:, :h], L[:h, :h], inv[0])
    X2 = _solve_rt_leafinv(B[:, h:] - _mm(X1, L[h:, :h], transpose_b=True),
                           L[h:, h:], inv[1])
    return torch.cat([X1, X2], dim=1)


def _chol_solve_leafinv(A, b):
    """(L, the tree of leaf inverses, v = L⁻¹b) in one recursion, as
    `_chol_solve_recursive` but each leaf comes with its inverse (K5), so
    every triangular solve, panel and right-hand side, is a GEMM."""
    n = A.shape[0]
    if n <= BASE:
        L, M = chol_inv_block(A.contiguous())     # K5 takes a contiguous block, not a view
        return L, M, _mm(M, b)
    h = n // 2
    L11, inv1, v1 = _chol_solve_leafinv(A[:h, :h], b[:h])
    L21 = _solve_rt_leafinv(A[h:, :h], L11, inv1)
    L22, inv2, v2 = _chol_solve_leafinv(A[h:, h:] - _mm(L21, L21, transpose_b=True),
                                        b[h:] - _mm(L21, v1))
    return _blocks(L11, L21, L22), (inv1, inv2), torch.cat([v1, v2], dim=0)


def evidence_fused(K, m, force: bool = False):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ, L) in one fused blocked sweep.  The blocked
    recursion runs with `force` or on the card when N > 2·BASE splits into
    BASE blocks (with leaf inverses under PALLAS_BASE); otherwise one
    Cholesky and one triangular solve."""
    n = K.shape[-1]
    if _blocked(n, K.device.type == "cuda", force):
        if PALLAS_BASE:
            L, _inv, v = _chol_solve_leafinv(K, m)
        else:
            L, v = _chol_solve_recursive(K, m)
    else:
        L = chol(K)
        v = torch.linalg.solve_triangular(L, m, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return logdet, torch.sum(v * v), L
