"""GPC_TPU_EVIDENCE=panel: the panel kernel (K3) as the FTC evidence engine.

Counterpart of gpc_tpu/ops/panel_engine.py, forward and backward.  For the CLI
kernel family cmpnd(rbf[, bias...][, white...][, whitefixed...]):

  * rank-1 bias split — K = K₀ + c·𝟙𝟙ᵀ with K₀ = rbf + noise·I.  𝟙 rides
    the panel forward solve as one extra RHS column, and G = v·vᵀ gives
      logdet K = logdet K₀ + log(1 + c·s),   s = G[-1, -1] = 𝟙ᵀK₀⁻¹𝟙,
      mⱼᵀK⁻¹mⱼ = G[j, j] − c·G[j, -1]²/(1 + c·s);
  * ragged N — X and the RHS are zero-padded to the panel width; pad rows
    carry no kernel mass, factor as √noise·I and contribute exactly
    (Npad − N)·log noise, subtracted here.

On a CUDA tensor this runs the K3 launches; on a CPU tensor, K3's plain
version.  `kern_evidence_panel` runs the panel engine only: a kernel outside
the family (`panel_split` is None) or a noiseless one (`panel_noiseless`:
pad rows would factor as 0·I) raises ValueError.  ops/evidence_mode.
resolve_engine sends both elsewhere first, with gpc_tpu's warnings.

Training: `_PanelCore` is the counterpart of gpc_tpu's custom VJP
(`_panel_core_fn`).  When no input needs a gradient the forward is K3 mode
"full"; otherwise mode "full+diag", which leaves bf16(L_jj⁻¹) in T's
diagonal blocks.  The backward rebuilds L from T (one batched triangular
solve inverts the diagonal blocks back to L_jj), takes L⁻¹ by blocked
inversion, and forms the evidence cotangents
  α = L⁻ᵀv = K₀⁻¹rhs,   K⁻¹ = L⁻ᵀL⁻¹,
  K̄ = ḡ_ld·K⁻¹ − α·sym(Ḡ)·αᵀ,   rhs̄ = 2·α·sym(Ḡ),
then maps K̄ to (X̄, γ̄, σ̄², noise̅) through the masked dense Gram plus
noise·I under autograd (K1 on the card).  The large products are f32
`torch.matmul` without TF32 on the card, as gpc_tpu leaves them to XLA.
This explicit-K⁻¹ backward costs several forwards (2N³ flops for K⁻¹
alone); gradients carry the bf16 factor's drift (~1e-2 relative).
"""

from __future__ import annotations

import torch

from gpc_tpu_torch import linalg
from gpc_tpu_torch.kernels import Cmpnd
from gpc_tpu_torch.ops.chol_panel import LEAF, diag_blocks, panel_state_rbf
from gpc_tpu_torch.ops.gram import dist_gram, recompute_vjp


def panel_split(kern):
    """(rbf_off, bias_offs, white_offs, fixed_white) of the panel family in
    `kern` — parameter offsets such that inv_width = p[rbf_off], variance =
    p[rbf_off+1], c = Σ p[bias_offs], noise = Σ p[white_offs] + fixed_white —
    or None when the family does not apply."""
    if getattr(kern, "kind", None) == "rbf":
        return 0, (), (), 0.0
    if not isinstance(kern, Cmpnd):
        return None
    off = kern.offsets()
    rbf_off = None
    bias_offs, white_offs = [], []
    fixed_white = 0.0
    for i, c in enumerate(kern.components):
        if c.kind == "rbf":
            if rbf_off is not None:
                return None     # two RBFs don't collapse to one panel Gram
            rbf_off = off[i]
        elif c.kind == "bias":
            bias_offs.append(off[i])
        elif c.kind == "white":
            white_offs.append(off[i])
        elif c.kind == "whitefixed":
            fixed_white += float(c.fixed_variance)
        else:
            return None
    if rbf_off is None:
        return None
    return rbf_off, tuple(bias_offs), tuple(white_offs), fixed_white


def _dense_k0(X, iw, var, noise, n_valid: int):
    """The differentiable twin of K3's in-kernel Gram: rbf(X, X) with rows
    and columns ≥ n_valid masked out, plus noise·I.  Pad rows carry only the
    noise ridge, so pad cotangents (with the (Npad − N)·log noise term the
    caller subtracts) cancel."""
    K = dist_gram("rbf", torch.stack([iw, var]), X, X)
    npad = X.shape[0]
    if n_valid < npad:
        valid = torch.arange(npad, device=X.device) < n_valid
        K = torch.where(valid[:, None] & valid[None, :], K, 0.0)
    return torch.diagonal_scatter(K, K.diagonal() + noise)


class _PanelCore(torch.autograd.Function):
    """(logdet₀, G) = K3(X, rhs, iw, var, noise) over the padded problem,
    with the analytic backward of the module docstring."""

    @staticmethod
    def forward(ctx, X, rhs, iw, var, noise, n_valid):
        ld, G, v, T = panel_state_rbf(X, rhs, iw, var, noise, n_valid=n_valid,
                                      mode="full+diag")
        ctx.n_valid = n_valid
        ctx.save_for_backward(X, rhs, iw, var, noise, v, T)
        return ld, G

    @staticmethod
    def backward(ctx, g_ld, g_G):
        X, rhs, iw, var, noise, v, T = ctx.saved_tensors
        dt = v.dtype
        L = T.to(dt)
        # T's diagonal blocks hold L_jj⁻¹: one batched solve gives L_jj back
        blocks = diag_blocks(L)
        eye = torch.eye(LEAF, dtype=dt, device=L.device).expand_as(blocks)
        blocks.copy_(torch.linalg.solve_triangular(blocks, eye, upper=False))
        Linv = linalg.blocked_tri_inv(L)
        del L
        alpha = Linv.T @ v.T                       # K₀⁻¹rhs, (Npad, D')
        Kbar = Linv.T @ Linv                       # K₀⁻¹
        del Linv
        Gs = 0.5 * (g_G + g_G.T).to(dt)
        aG = alpha @ Gs
        Kbar.mul_(g_ld.to(dt)).addmm_(aG, alpha.T, alpha=-1.0)
        Xb, iwb, varb, nzb = recompute_vjp(
            lambda *a: _dense_k0(*a, ctx.n_valid), (X, iw, var, noise),
            (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:5], Kbar)
        rhsb = (2.0 * aG).to(rhs.dtype) if ctx.needs_input_grad[1] else None
        return Xb, rhsb, iwb, varb, nzb, None


def panel_noiseless(info) -> bool:
    """Whether a kernel of the panel family (panel_split's `info`) has no
    white or fixed-white noise to ridge its pad rows."""
    _rbf_off, _bias_offs, white_offs, fixed_white = info
    return not white_offs and fixed_white <= 0.0


def kern_evidence_panel(kern, p, X, m):
    """(logdet, quad) for K = kern(X) through the panel kernel; `kern` is of
    the family and has noise (module docstring)."""
    info = panel_split(kern)
    if info is None or panel_noiseless(info):
        raise ValueError("kern_evidence_panel takes cmpnd(rbf[, bias][, white]) with a "
                         f"white/noise ridge (got {getattr(kern, 'kind', type(kern).__name__)})")
    rbf_off, bias_offs, white_offs, fixed_white = info
    iw = p[rbf_off]
    var = p[rbf_off + 1]
    noise = sum((p[o] for o in white_offs),
                torch.as_tensor(fixed_white, dtype=p.dtype, device=p.device))
    n = X.shape[0]
    npad = -(-n // LEAF) * LEAF          # the next multiple of the panel width
    Xp = torch.nn.functional.pad(X, (0, 0, 0, npad - n))
    cols = [m]
    if bias_offs:
        cols.append(torch.ones((n, 1), dtype=m.dtype, device=m.device))
    rhs = torch.nn.functional.pad(torch.cat(cols, dim=1), (0, 0, 0, npad - n))
    args = (Xp.contiguous(), rhs.contiguous(), iw, var, noise)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        ld0, G = _PanelCore.apply(*args, n)
    else:
        ld0, G, _v, _T = panel_state_rbf(*args, n_valid=n)
    ld0 = ld0.to(p.dtype) - (npad - n) * torch.log(noise)
    G = G.to(p.dtype)
    if not bias_offs:
        return ld0, torch.trace(G)
    c = sum(p[o] for o in bias_offs)
    s = G[-1, -1]
    u = G[:-1, -1]
    qm = torch.sum(torch.diagonal(G)[:-1])
    denom = 1.0 + c * s
    return ld0 + torch.log(denom), qm - c * torch.sum(u * u) / denom
