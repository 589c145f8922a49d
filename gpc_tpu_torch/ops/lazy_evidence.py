"""GPC_TPU_EVIDENCE=lazy: Gram blocks materialize inside the factorization.

Counterpart of gpc_tpu/ops/lazy_evidence.py's general-kernel engine
(`kern_block_fn`, `bias_split`, `_evidence_bias_split`,
`kern_evidence_lazy`).  Instead of a dense K the left-looking recursion of
ops/evidence_fast.py takes a block thunk `kfn(i0, j0, bi, bj)`: each block
comes from the kernel's own `compute` on the rows it needs (K1 or K4 on the
card) at its point of first use, with the white variance and the ridge on
diagonal blocks only.  The rank-1 bias term c·𝟙𝟙ᵀ of a cmpnd(·, bias,
white) is always split off by Sherman-Morrison: the factored matrix is K₀
without bias, and 𝟙 rides the forward solve as one more column.

The engine differentiates (Policy leafinv=False: Cholesky and triangular
solves, f32 GEMMs without TF32 on the card, f64 on the CPU), as gpc_tpu's
always does.  On the card a call that needs no gradient takes the forward
policy of ops/evidence_fast.py instead, K5 leaves (leafinv="pallas",
gpc_tpu's `Policy()` default): the leaf inverse turns the triangular
solves against leaves into GEMMs.  gpc_tpu's kern_evidence_lazy keeps
Cholesky leaves there too; the two agree to float32 rounding.  gpc_tpu's
GPC_TPU_BF16_EVIDENCE, GPC_TPU_BIAS_SPLIT and GPC_TPU_EVIDENCE_PRESTACK
knobs are not ported: the policy is fixed and the bias split always on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpc_tpu_torch.kernels import Bias, Cmpnd
from gpc_tpu_torch.ops.chol_blocked import evidence_fused
from gpc_tpu_torch.ops.chol_pallas import CHOL_MAX
from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_left_fast, evidence_left_v
from gpc_tpu_torch.ops.evidence_mode import evidence_base


def kern_block_fn(kern, p, X, ridge=0.0):
    """Block thunk for any kernel: K blocks from the kernel's cross compute
    (white-free off the diagonal), with the white variance plus `ridge`
    added on diagonal blocks.  Relies on diag(p, X) equalling the diagonal
    of compute(p, X, X) plus white(p), which every kernel of kernels.py
    keeps (the dense route's gram() overwrite is exactly the white shift)."""
    shift = kern.white(p) + ridge

    def kfn(i0, j0, bi, bj):
        K = kern.compute(p, X[i0:i0 + bi], X[j0:j0 + bj])
        if i0 == j0:
            K = torch.diagonal_scatter(K, K.diagonal() + shift)
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
        pol = Policy(base=base, bf16=False, leafinv="pallas" if k5 else False, stack=True)
        sp = bias_split(kern)
        if sp is not None:
            return _evidence_bias_split(sp[0], sp[1], p, X, m, ridge, pol)
        return evidence_left_fast(kern_block_fn(kern, p, X, ridge), n, m, pol)
    K = kern.compute(p, X, X)
    K = torch.diagonal_scatter(K, K.diagonal() + (kern.white(p) + ridge))
    logdet, quad, _L = evidence_fused(K, m, force=force)
    return logdet, quad
