"""GPC_TPU_EVIDENCE=lazy: Gram blocks materialize inside the factorization
(counterpart of gpc_tpu/ops/lazy_evidence.py).

Instead of a dense K the left-looking recursion of ops/evidence_fast.py
takes a block thunk `kfn(i0, j0, bi, bj)` (`kern_block_fn`): each block
comes from the kernel's own `compute` on the rows it needs (K1 or K4 on the
card) at its point of first use, with the noise or white variance on
diagonal blocks only.

`kern_evidence_lazy` runs it for any kernel at a size that splits into
base blocks (ops/evidence_mode.resolve_engine sends every other size to
the dense engine).  The rank-1 bias term c·𝟙𝟙ᵀ of a cmpnd(·, bias, white)
is split off by Sherman-Morrison: the factored matrix is K₀ without bias,
and 𝟙 rides the forward solve as one more column.  The engine
differentiates (Policy leafinv=False: Cholesky and triangular solves, f32
GEMMs without TF32 on the card, f64 on the CPU), as gpc_tpu's always does.
On the card a call that needs no gradient takes K5 leaves instead
(leafinv="pallas", gpc_tpu's `Policy()` default): the leaf inverse turns
the triangular solves against leaves into GEMMs.  gpc_tpu keeps Cholesky
leaves there too; the two agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpc_tpu_torch.kernels import Bias, Cmpnd
from gpc_tpu_torch.ops.chol_pallas import CHOL_MAX
from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_left_fast, evidence_left_v


def kern_block_fn(kern, p, X):
    """Block thunk for any kernel: K blocks from the kernel's cross compute
    (white-free off the diagonal); a diagonal block's diagonal is the
    kernel's own diag(p, X_b) (which holds the white variance), as the
    dense route's gram() overwrites it.  The values are those of compute's
    diagonal plus the white shift, which every kernel of kernels.py keeps;
    the gradient is diag's, finite where compute's is not (exp's
    √(d2 + tiny) at zero distance).  gpc_tpu's lazy engine adds the shift
    to compute's diagonal (a deviation, ROADMAP.md)."""

    def kfn(i0, j0, bi, bj):
        K = kern.compute(p, X[i0:i0 + bi], X[j0:j0 + bj])
        if i0 == j0:
            K = torch.diagonal_scatter(K, kern.diag(p, X[i0:i0 + bi]))
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


def _evidence_bias_split(kern0, slots, p, X, m, pol):
    """Evidence of K = K₀ + c·𝟙𝟙ᵀ from ONE factorization of K₀ with the
    augmented right-hand side [m | 𝟙]:
      logdet K = logdet K₀ + log(1 + c·s),       s  = 𝟙ᵀK₀⁻¹𝟙,
      mⱼᵀK⁻¹mⱼ = mⱼᵀK₀⁻¹mⱼ − c·uⱼ²/(1 + c·s),  uⱼ = 𝟙ᵀK₀⁻¹mⱼ."""
    n = X.shape[0]
    keep = np.setdiff1d(np.arange(p.shape[0]), np.asarray(slots))
    p0 = p[torch.as_tensor(keep, device=p.device)]
    c = sum(p[s] for s in slots)
    rhs = torch.cat([m, torch.ones((n, 1), dtype=m.dtype, device=m.device)], dim=1)
    logdet0, v = evidence_left_v(kern_block_fn(kern0, p0, X), n, rhs, pol)
    G = v.T @ v
    s = G[-1, -1]
    u = G[:-1, -1]
    qm = torch.diagonal(G)[:-1]
    denom = 1.0 + c * s
    return logdet0 + torch.log(denom), torch.sum(qm) - c * torch.sum(u * u) / denom


def kern_evidence_lazy(kern, p, X, m, base: int):
    """(logdet, quad) for K = kern(X) with the Gram blocks fused into the
    left-looking factorization over leaves of `base` rows.  N must split:
    a multiple of base, more than two of them.  The leaves are K5's on the
    card when no input needs a gradient, Cholesky factors otherwise (module
    docstring)."""
    n = X.shape[0]
    if n % base or n <= 2 * base:
        raise ValueError(f"kern_evidence_lazy: N = {n} does not split into {base}-blocks")
    needs_grad = torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in (p, X, m))
    k5 = X.device.type == "cuda" and not needs_grad and base <= CHOL_MAX
    pol = Policy(base=base, leafinv="pallas" if k5 else False)
    sp = bias_split(kern)
    if sp is not None:
        return _evidence_bias_split(sp[0], sp[1], p, X, m, pol)
    return evidence_left_fast(kern_block_fn(kern, p, X), n, m, pol)
