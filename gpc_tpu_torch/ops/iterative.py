"""Matrix-free iterative GP evidence: blockwise MVMs, batched CG, SLQ logdet.

Counterpart of gpc_tpu/ops/iterative.py (the BBMM recipe, PAPERS.md:
Gardner et al. 2018).  The Gram matrix is never materialized: K·V comes in
row blocks straight from the kernel's cross compute (K1/K4 on the card, one
launch per block × N tile), the quadratic form mᵀK⁻¹m from batched
conjugate gradients, and log|K| from stochastic Lanczos quadrature over
Rademacher probes.  quad is exact to CG tolerance; logdet is unbiased with
O(1/√probes) noise: a training-grade estimate, not a parity route.

What differs from gpc_tpu, by design:

  * Early exit.  gpc_tpu's `lax.while_loop` stops at the first iteration
    where max‖r‖/‖b‖ ≤ tol.  Here every iteration computes that flag on the
    device and freezes the update (`torch.where`) once it holds; the host
    reads the flag every CHECK_EVERY iterations and leaves the loop.  The
    result is the first-stop result, bit for bit, with one host sync per
    CHECK_EVERY iterations.  In float32 the default tol = 1e-10 is out of
    reach, so on the card CG runs all `cg_iters`.
  * Lanczos over probes.  gpc_tpu vmaps one Lanczos per probe; here the P
    probes are the P columns of one block, so each MVM is one pass of row
    blocks, with per-column reorthogonalisation and one batched `eigh` of
    the (P, k, k) tridiagonals.
  * Probes.  gpc_tpu draws Rademacher probes from `jax.random` (threefry),
    which torch cannot reproduce.  The port draws them from a
    `torch.Generator` on the data's device seeded with `cfg.seed`
    (`rademacher_probes`): a different draw, and an equally unbiased
    estimate.  Every function that draws probes also takes them as an
    argument, so a caller can pass gpc_tpu's exact draw.
  * Memory.  `kernel_mvm` is an autograd Function whose backward
    recomputes each row block's Gram inside the block loop, and the
    evidence's backward contracts block by block the same way: peak memory
    stays O(N·(block + D + T)), never all the blocks.

The evidence cores (`_IterEvidence`, masked or not) are the counterparts of
gpc_tpu's two custom VJPs (`_iter_evidence_fn`, `_iter_evidence_masked_fn`):

  quad   = Σⱼ mⱼᵀαⱼ,  α = K⁻¹m by (preconditioned) CG
  logdet = SLQ over `probes` Rademacher vectors
  ∂quad/∂θ   = −Σⱼ αⱼᵀ(∂K/∂θ)αⱼ,          ∂quad/∂m = 2α
  ∂logdet/∂θ ≈ (1/T)Σᵢ wᵢᵀ(∂K/∂θ)zᵢ,  w = K⁻¹z solved alongside m in ONE
               multi-RHS CG (Hutchinson, T = trace_probes),

with θ = (p, X).  The probes are fixed by the seed, so the objective is
deterministic and its gradient is the exact gradient of a fixed-probe
estimator (SCG's line searches stay consistent).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from gpc_tpu_torch import ndlutil

# the (P)CG result of the last evidence forward (its iterations and
# per-column residuals), for reports such as chip_smoke.py's
LAST_SOLVE = None

# CG iterations between two host reads of the device's stop flag
CHECK_EVERY = 8


def _blocks(n: int, block: int):
    return [(r0, min(r0 + block, n)) for r0 in range(0, n, block)]


def _self_entries(kern, p, X, lo, r0, r1):
    """The white-free Gram's entries of rows [lo + r0, lo + r1) of X against
    themselves: diag less the white variance, as the dense route's gram()
    overwrites them (finite gradients where compute's are not: exp's
    √(d2 + tiny) at zero distance; gpc_tpu keeps compute's, a deviation)."""
    return kern.diag(p, X[lo + r0:lo + r1]) - kern.white(p)


def _raw_mvm(kern, p, X, V, block, rows=None):
    """Σ_blocks K₀(X_b, X)·V, K₀ the Gram without the white term, no
    autograd: rows [lo, hi) = `rows` of X (all of them by default) against
    all of X, so a rank of the distributed engine computes its row block.
    A block's entries of a point against itself are `_self_entries`."""
    lo, hi = rows if rows is not None else (0, X.shape[0])
    out = torch.empty((hi - lo, V.shape[1]), dtype=V.dtype, device=V.device)
    for r0, r1 in _blocks(hi - lo, block):
        Kb = kern.compute(p, X[lo + r0:lo + r1], X)
        Kb.diagonal(offset=lo + r0).copy_(_self_entries(kern, p, X, lo, r0, r1))
        out[r0:r1] = Kb @ V
    return out


def _mvm_vjp_raw(kern, p, X, V, G, block: int, need_p: bool, need_X: bool, rows=None):
    """(p̄, X̄) of Σ G∘(K₀[rows]·V), K₀ = the white-free Gram and G the
    cotangent of those rows: each row block's Gram is recomputed under
    autograd and its cotangent G_b·Vᵀ pulled back at once, so no two blocks
    live together.  Entries not asked for are None."""
    lo, hi = rows if rows is not None else (0, X.shape[0])
    with torch.enable_grad():
        pd = p.detach().requires_grad_(need_p)
        Xd = X.detach().requires_grad_(need_X)
        wanted = [t for t in (pd, Xd) if t.requires_grad]
        acc = [torch.zeros_like(t) for t in wanted]
        for r0, r1 in _blocks(hi - lo, block):
            Kb = torch.diagonal_scatter(kern.compute(pd, Xd[lo + r0:lo + r1], Xd),
                                        _self_entries(kern, pd, Xd, lo, r0, r1),
                                        offset=lo + r0)
            if not Kb.requires_grad:
                continue
            gs = torch.autograd.grad(Kb, wanted, G[r0:r1] @ V.T, allow_unused=True)
            acc = [a if g is None else a + g for a, g in zip(acc, gs)]
    it = iter(acc)
    return (next(it) if need_p else None), (next(it) if need_X else None)


def mvm_vjp(kern, p, X, V, G, block: int, need_p: bool = True, need_X: bool = True,
            rows=None):
    """(p̄, X̄) of Σ G∘(K[rows]·V), K = kern(X) with its white term, block
    by block (`kernel_mvm`'s pullback without its forward); `rows` as in
    `_raw_mvm`, G then the cotangent of those rows."""
    pbar, Xbar = _mvm_vjp_raw(kern, p, X, V, G, block, need_p, need_X, rows)
    if need_p:
        lo, hi = rows if rows is not None else (0, X.shape[0])
        with torch.enable_grad():
            pd = p.detach().requires_grad_(True)
            w = kern.white(pd)
            if w.requires_grad:
                (gw,) = torch.autograd.grad(w * torch.sum(G * V[lo:hi]), pd)
                pbar = pbar + gw
    return pbar, Xbar


class _BlockMVM(torch.autograd.Function):
    """Σ_blocks compute(p, X_b, X)·V; the backward recomputes each block."""

    @staticmethod
    def forward(ctx, kern, block, p, X, V):
        ctx.kern, ctx.block = kern, block
        ctx.save_for_backward(p, X, V)
        return _raw_mvm(kern, p, X, V, block)

    @staticmethod
    def backward(ctx, G):
        p, X, V = ctx.saved_tensors
        kern, block = ctx.kern, ctx.block
        need_p, need_X, need_V = ctx.needs_input_grad[2:5]
        # the white term rides outside this Function (kernel_mvm), so
        # pull back through the block Grams alone
        Vbar = _raw_mvm(kern, p, X, G, block) if need_V else None   # K symmetric
        pbar = Xbar = None
        if need_p or need_X:
            pbar, Xbar = _mvm_vjp_raw(kern, p, X, V, G, block, need_p, need_X)
        return None, None, pbar, Xbar, Vbar


def kernel_mvm(kern, p, X, V, block: int = 2048):
    """K·V without materializing K: Σ_blocks compute(p, X_b, X)·V + white·V
    (diag ≡ compute(x, x) + white for every kernel of kernels.py).  On the
    card each row block is one K1/K4 launch of block × N.  Differentiable
    in p, X and V; the backward recomputes one block at a time."""
    return _BlockMVM.apply(kern, block, p, X, V) + kern.white(p) * V


class CgResult(NamedTuple):
    x: torch.Tensor
    residual: torch.Tensor
    iters: torch.Tensor


def cg_solve(mvm, B, max_iters: int = 256, tol: float = 1e-10):
    """Batched conjugate gradients for SPD systems K·X = B (B: (N, D)),
    gpc_tpu's iteration with the frozen-flag early exit of the module
    docstring."""
    X = torch.zeros_like(B)
    R, P = B, B
    rs = torch.sum(R * R, dim=0)
    bnorm = torch.sqrt(torch.sum(B * B, dim=0)) + 1e-300
    it = torch.zeros((), dtype=torch.int64, device=B.device)
    for k in range(max_iters):
        active = torch.max(torch.sqrt(rs) / bnorm) > tol
        if k and k % CHECK_EVERY == 0 and not bool(active):
            break
        Kp = mvm(P)
        alpha = rs / (torch.sum(P * Kp, dim=0) + 1e-300)
        Xn = X + P * alpha[None, :]
        Rn = R - Kp * alpha[None, :]
        rs_new = torch.sum(Rn * Rn, dim=0)
        beta = rs_new / (rs + 1e-300)
        Pn = Rn + P * beta[None, :]
        X, R, P, rs = (torch.where(active, Xn, X), torch.where(active, Rn, R),
                       torch.where(active, Pn, P), torch.where(active, rs_new, rs))
        it = it + active.to(it.dtype)
    return CgResult(x=X, residual=torch.sqrt(rs), iters=it)


def pcg_solve(mvm, B, precond, max_iters: int = 256, tol: float = 1e-10):
    """Preconditioned CG for SPD K·X = B with M⁻¹ ≈ K⁻¹ given by `precond`,
    with the frozen-flag early exit."""
    X = torch.zeros_like(B)
    R = B
    Z = precond(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    bnorm = torch.sqrt(torch.sum(B * B, dim=0)) + 1e-300
    it = torch.zeros((), dtype=torch.int64, device=B.device)
    for k in range(max_iters):
        active = torch.max(torch.sqrt(torch.sum(R * R, dim=0)) / bnorm) > tol
        if k and k % CHECK_EVERY == 0 and not bool(active):
            break
        Kp = mvm(P)
        alpha = rz / (torch.sum(P * Kp, dim=0) + 1e-300)
        Xn = X + P * alpha[None, :]
        Rn = R - Kp * alpha[None, :]
        Zn = precond(Rn)
        rz_new = torch.sum(Rn * Zn, dim=0)
        beta = rz_new / (rz + 1e-300)
        Pn = Zn + P * beta[None, :]
        X, R, Z, P, rz = (torch.where(active, Xn, X), torch.where(active, Rn, R),
                          torch.where(active, Zn, Z), torch.where(active, Pn, P),
                          torch.where(active, rz_new, rz))
        it = it + active.to(it.dtype)
    return CgResult(x=X, residual=torch.sqrt(torch.sum(R * R, dim=0)), iters=it)


def _lanczos(mvm, Z, k: int):
    """k-step Lanczos with full reorthogonalization, one run per column of
    Z (N, P), all P through each MVM; returns (alphas, betas), each (k, P)."""
    N, P = Z.shape
    q = Z / torch.linalg.vector_norm(Z, dim=0)[None, :]
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((P,), dtype=Z.dtype, device=Z.device)
    Q = torch.zeros((k, N, P), dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for i in range(k):
        w = mvm(q) - beta_prev[None, :] * q_prev
        alpha = torch.sum(w * q, dim=0)
        w = w - alpha[None, :] * q
        # full reorthogonalization of each column against its stored basis
        w = w - torch.einsum("knp,kp->np", Q, torch.einsum("knp,np->kp", Q, w))
        beta = torch.linalg.vector_norm(w, dim=0)
        q_next = w / torch.where(beta > 0, beta, 1.0)[None, :]
        Q[i] = q
        q_prev, q, beta_prev = q, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def rademacher_probes(seed: int, N: int, trace_probes: int, probes: int, dtype, device):
    """(Z_trace (N, trace_probes), Z_slq (N, probes)): ±1 entries from one
    torch.Generator on `device` seeded with `seed`, drawn in that order.
    gpc_tpu draws from jax.random under fold_in(PRNGKey(seed), N); this is
    a different draw of the same distribution."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def draw(cols):
        z = torch.randint(0, 2, (N, cols), generator=g, device=device)
        return (2 * z - 1).to(dtype)
    return draw(trace_probes), draw(probes)


def slq_logdet(mvm, N: int, probes: int = 16, lanczos_iters: int = 32,
               dtype=torch.float64, device="cpu", seed: int = 0, Z=None):
    """Stochastic Lanczos quadrature estimate of log|K|: the mean over the
    columns of Z (N, probes) of N·Σ τ²·log θ over each tridiagonal's
    eigenpairs.  Z defaults to `probes` Rademacher columns from the
    generator seeded with `seed`."""
    if Z is None:
        Z = rademacher_probes(seed, N, 0, probes, dtype, device)[1]
    alphas, betas = _lanczos(mvm, Z, lanczos_iters)
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T[:, :-1], 1)
         + torch.diag_embed(betas.T[:, :-1], -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-300)
    tau2 = evecs[:, 0, :] ** 2
    return torch.mean(torch.sum(tau2 * torch.log(evals), dim=1) * N)


def iterative_evidence(kern, p, X, m, seed: int = 0, block: int = 2048,
                       probes: int = 16, lanczos_iters: int = 32,
                       cg_iters: int = 256, precond_rank: int = 0, Z=None):
    """Matrix-free (quad, logdet): quad = Σⱼ mⱼᵀK⁻¹mⱼ by (preconditioned)
    CG, logdet by SLQ over the probe columns Z (drawn from `seed` when
    None).  precond_rank > 0 builds the pivoted-Cholesky/Woodbury
    preconditioner.  Forward only; `kern_evidence_iterative` is the
    differentiable engine."""
    with torch.no_grad():
        mvm = lambda V: kernel_mvm(kern, p, X, V, block=block)   # noqa: E731
        if precond_rank > 0:
            Lk = pivoted_cholesky(kern, p, X, precond_rank)
            pre = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)
            sol = pcg_solve(mvm, m, pre, max_iters=cg_iters)
        else:
            sol = cg_solve(mvm, m, max_iters=cg_iters)
        quad = torch.sum(m * sol.x)
        logdet = slq_logdet(mvm, X.shape[0], probes=probes, lanczos_iters=lanczos_iters,
                            dtype=X.dtype, device=X.device, seed=seed, Z=Z)
    return quad, logdet


def pivoted_cholesky(kern, p, X, rank: int, mask=None):
    """Greedy rank-k pivoted Cholesky of the white-free kernel matrix
    (PAPERS.md: Cutajar et al. 2016): k steps, each picking the largest
    remaining diagonal (first on ties, as gpc_tpu), evaluating ONE kernel
    column (an N × 1 K1/K4 launch on the card) and downdating.  O(N·k)
    memory, no host synchronisation.  Returns Lk (N, k).  With `mask`,
    masked-out rows are never pivots and their Lk rows are zero."""
    N = X.shape[0]
    d = kern.diag(p, X) - kern.white(p)
    if mask is not None:
        d = d * mask
    Lk = torch.zeros((N, rank), dtype=X.dtype, device=X.device)
    for i in range(rank):
        piv = torch.argmax(d).reshape(1)
        col = kern.compute(p, X, X.index_select(0, piv))[:, 0]
        if mask is not None:
            col = col * mask
        li = Lk.index_select(0, piv)[0]
        col = col - Lk @ li
        pivot_val = torch.clamp(d.index_select(0, piv), min=1e-12)
        newcol = (col / torch.sqrt(pivot_val)).index_put((piv,), torch.sqrt(pivot_val))
        if mask is not None:
            newcol = newcol * mask
        Lk[:, i] = newcol
        d = torch.clamp(d - newcol * newcol, min=0.0).index_put(
            (piv,), torch.zeros((1,), dtype=d.dtype, device=d.device))
    return Lk


def pivoted_cholesky_masked(kern, p, X, mask, rank: int):
    """Masked-rows variant of `pivoted_cholesky`."""
    return pivoted_cholesky(kern, p, X, rank, mask=mask)


def woodbury_preconditioner(Lk, sigma2):
    """Solve (Lk·Lkᵀ + σ²I)⁻¹·r via Woodbury, as a closure for PCG."""
    k = Lk.shape[1]
    inner = sigma2 * torch.eye(k, dtype=Lk.dtype, device=Lk.device) + Lk.T @ Lk
    Linner = torch.linalg.cholesky(inner)

    def solve(R):
        t = torch.cholesky_solve(Lk.T @ R, Linner)
        return (R - Lk @ t) / sigma2

    return solve


class IterConfig(NamedTuple):
    """The iterative engine's settings (env-overridable, see `iter_config`)."""
    block: int = 2048
    probes: int = 16
    lanczos_iters: int = 32
    cg_iters: int = 256
    precond_rank: int = 0
    trace_probes: int = 16
    seed: int = 0


def iter_config() -> IterConfig:
    """GPC_TPU_ITER_{BLOCK,PROBES,LANCZOS,CG,PRECOND,TPROBES,SEED}, as in
    gpc_tpu, for the GPC_TPU_EVIDENCE=iterative engine."""
    g = lambda k, d: int(os.environ.get(f"GPC_TPU_ITER_{k}", d))   # noqa: E731
    return IterConfig(block=g("BLOCK", 2048), probes=g("PROBES", 16),
                      lanczos_iters=g("LANCZOS", 32), cg_iters=g("CG", 256),
                      precond_rank=g("PRECOND", 0),
                      trace_probes=g("TPROBES", 16), seed=g("SEED", 0))


def _masked(mask, V):
    return V if mask is None else V * mask[:, None]


class _IterEvidence(torch.autograd.Function):
    """(logdet, quad) of K̃ = kern(X), or, with a 0/1 `mask`, of
    mask·K·mask + (I − mask); differentiable in (p, X, m) as the module
    docstring sets out.  Break rows of the masked form have eigenvalue 1:
    they add 0 to logdet and, with the RHS zero there, nothing to quad."""

    @staticmethod
    def forward(ctx, kern, cfg, Ztr, Zslq, mask, p, X, m):
        N, D = m.shape

        def mvm(V):
            if mask is None:
                return kernel_mvm(kern, p, X, V, block=cfg.block)
            out = kernel_mvm(kern, p, X, _masked(mask, V), block=cfg.block)
            return _masked(mask, out) + (1.0 - mask[:, None]) * V

        B = torch.cat([m, Ztr], dim=1)
        if cfg.precond_rank > 0:
            Lk = pivoted_cholesky(kern, p, X, cfg.precond_rank, mask=mask)
            wsolve = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)
            if mask is None:
                pre = wsolve
            else:
                def pre(R):
                    return _masked(mask, wsolve(_masked(mask, R))) + (1.0 - mask[:, None]) * R
            sol = pcg_solve(mvm, B, pre, max_iters=cfg.cg_iters)
        else:
            sol = cg_solve(mvm, B, max_iters=cfg.cg_iters)
        alpha, W = sol.x[:, :D], sol.x[:, D:]
        quad = torch.sum(m * alpha)
        logdet = slq_logdet(mvm, N, lanczos_iters=cfg.lanczos_iters, Z=Zslq)
        ctx.kern, ctx.cfg, ctx.mask = kern, cfg, mask
        global LAST_SOLVE
        LAST_SOLVE = sol
        ctx.save_for_backward(p, X, alpha, W, Ztr)
        return logdet, quad

    @staticmethod
    def backward(ctx, g_ld, g_quad):
        p, X, alpha, W, Ztr = ctx.saved_tensors
        kern, cfg, mask = ctx.kern, ctx.cfg, ctx.mask
        need_p, need_X, need_m = ctx.needs_input_grad[5:8]
        pbar = Xbar = None
        if need_p or need_X:
            # one blockwise pass: Σ G∘(K·V) with V = [α̃ | Z̃] and G =
            # [−ḡ_quad·α̃ | ḡ_ld/T·W̃] is ḡ_ld·s_tr/T − ḡ_quad·s_q (the
            # identity part of the masked operator is (p, X)-free)
            am = _masked(mask, alpha)
            V = torch.cat([am, _masked(mask, Ztr)], dim=1)
            G = torch.cat([-g_quad * am, (g_ld / cfg.trace_probes) * _masked(mask, W)], dim=1)
            pbar, Xbar = mvm_vjp(kern, p, X, V, G, cfg.block, need_p, need_X)
        mbar = 2.0 * g_quad * alpha if need_m else None
        return None, None, None, None, None, pbar, Xbar, mbar


def _probes_for(cfg: IterConfig, X, probes):
    if probes is not None:
        return tuple(torch.as_tensor(z, dtype=X.dtype, device=X.device) for z in probes)
    return rademacher_probes(cfg.seed, X.shape[0], cfg.trace_probes, cfg.probes,
                             X.dtype, X.device)


def kern_evidence_iterative(kern, p, X, m, cfg: Optional[IterConfig] = None, probes=None):
    """(logdet, quad) for K = kern(X), matrix-free and differentiable in
    (p, X, m), O(N·block) memory: the GPC_TPU_EVIDENCE=iterative engine of
    models/gp.py (FTC) and models/gplvm.py.  `probes` = (Z_trace (N, T),
    Z_slq (N, P)) replaces the seeded draw (`rademacher_probes`)."""
    cfg = iter_config() if cfg is None else cfg
    Ztr, Zslq = _probes_for(cfg, X, probes)
    return _IterEvidence.apply(kern, cfg, Ztr, Zslq, None, p, X, m)


def kern_evidence_iterative_masked(kern, p, X, m, mask, cfg: Optional[IterConfig] = None,
                                   probes=None):
    """(logdet, quad) of mask·kern(X)·mask + (I − mask), matrix-free: the
    iterative route of the GP-LVM's dynamics term (models/gplvm.py), where
    the mask knocks the sequence-break rows out to the identity."""
    cfg = iter_config() if cfg is None else cfg
    Ztr, Zslq = _probes_for(cfg, X, probes)
    return _IterEvidence.apply(kern, cfg, Ztr, Zslq, mask.to(X.dtype), p, X, m)


def make_iterative_nlml(kern, X, m, seed: int = 0, *, block: int = 2048,
                        probes: int = 16, lanczos_iters: int = 32,
                        cg_iters: int = 256, precond_rank: int = 0,
                        trace_probes: int = 16, probe_vectors=None):
    """Matrix-free trainable FTC NLML over fixed (X, m):
    nlml(p) = ½(Σⱼ mⱼᵀK⁻¹mⱼ + D·log|K| + N·D·log 2π) through the shared
    evidence core.  gpc_tpu takes a jax.random key and maps it to the
    core's seed; the port takes the seed itself (or the probe vectors)."""
    N, D = m.shape
    cfg = IterConfig(block=block, probes=probes, lanczos_iters=lanczos_iters,
                     cg_iters=cg_iters, precond_rank=precond_rank,
                     trace_probes=trace_probes, seed=seed)

    def nlml(p):
        logdet, quad = kern_evidence_iterative(kern, p, X, m, cfg, probes=probe_vectors)
        return 0.5 * (quad + D * logdet + N * D * ndlutil.LOGTWOPI)

    return nlml
