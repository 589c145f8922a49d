"""The port's matrix-free iterative engine (gpc_tpu_torch.ops.iterative)
against gpc_tpu.ops.iterative, on the CPU in float64.

Same numpy inputs through both packages.  Where gpc_tpu draws Rademacher
probes from jax.random, the port is given gpc_tpu's exact draw (built
below under gpc_tpu's key derivation), so the two estimators coincide:
kernel_mvm within 1e-12, its pullback within 1e-10; CG / PCG with gpc_tpu's
iteration count and, converged, within 1e-10 (relative L2), and the
frozen-flag early exit equal bit for bit to the first-stop loop; Lanczos'
α, β and SLQ within 1e-8; the pivoted Cholesky with the same pivots,
values within 1e-12; both evidence cores and their VJPs in (p, X, m)
within 1e-8; make_iterative_nlml and the FTC GP under
GPC_TPU_EVIDENCE=iterative as gpc_tpu's.  The port's own probe draw is
checked for what it must be: ±1, seeded, reproducible.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.ops import iterative as JI
from gpc_tpu_torch.interop.from_jax import from_jax, kern_from_desc
from gpc_tpu_torch.ops import iterative as TI


def _kern(q, kind="rbf"):
    lead = {"rbf": GK.Rbf, "mlp": GK.Mlp, "matern32": GK.Matern32}[kind]
    return GK.Cmpnd(input_dim=q, components=(
        lead(input_dim=q), GK.Bias(input_dim=q), GK.White(input_dim=q)))


def _setup(N=120, q=2, kind="rbf", seed=17):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, q))
    jk = _kern(q, kind)
    p = jk.default_params() * rng.uniform(0.5, 1.5, jk.n_params)
    return jk, kern_from_desc(jk), p, X, rng


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def jax_probes(seed, N, T, P):
    """gpc_tpu's probe draw: (Z_trace (N, T), Z_slq (N, P)) under
    fold_in(PRNGKey(seed), N), as _iter_evidence_fn and slq_logdet make it."""
    k_tr, k_slq = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), N))
    Ztr = np.asarray(jax.random.rademacher(k_tr, (N, T), dtype=jnp.float64))
    Zs = [np.asarray(jax.random.rademacher(k, (N,), dtype=jnp.float64))
          for k in jax.random.split(k_slq, P)]
    return Ztr.copy(), np.stack(Zs, axis=1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kind,block", [("rbf", 32), ("rbf", 500), ("mlp", 50), ("matern32", 64)])
def test_kernel_mvm_matches(kind, block):
    jk, tk, p, X, rng = _setup(kind=kind)
    V = rng.standard_normal((X.shape[0], 3))
    want = np.asarray(JI.kernel_mvm(jk, jnp.asarray(p), jnp.asarray(X), jnp.asarray(V),
                                    block=block))
    got = TI.kernel_mvm(tk, _t(p), _t(X), _t(V), block=block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_kernel_mvm_pullback_matches():
    """The blockwise backward (each block's Gram recomputed) equals the
    gradient of gpc_tpu's checkpointed kernel_mvm in p, X and V."""
    jk, tk, p, X, rng = _setup(N=90)
    V = rng.standard_normal((90, 2))
    G = rng.standard_normal((90, 2))
    f = lambda p_, X_, V_: jnp.sum(jnp.asarray(G) * JI.kernel_mvm(jk, p_, X_, V_, block=32))
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(p), jnp.asarray(X), jnp.asarray(V))
    args = [_t(a).requires_grad_(True) for a in (p, X, V)]
    got = torch.autograd.grad(torch.sum(_t(G) * TI.kernel_mvm(tk, *args, block=32)), args)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-10
    pb, Xb = TI.mvm_vjp(tk, _t(p), _t(X), _t(V), _t(G), 32)
    assert _rel(pb.numpy(), want[0]) < 1e-10 and _rel(Xb.numpy(), want[1]) < 1e-10


@pytest.mark.parametrize("tol", [1e-4, 1e-6, 1e-10])
def test_cg_matches_and_stops_where_gpc_tpu_stops(tol):
    """The same iteration count as gpc_tpu's while_loop at each tolerance,
    and the converged solve within 1e-10.  (CG's intermediate iterates
    amplify ulp-level differences: gpc_tpu's own CG moves by ~1e-5 at
    tol = 1e-2 when B moves by 1e-16; so the solutions are compared at
    convergence, the stopping point at every tolerance.)"""
    jk, tk, p, X, rng = _setup()
    B = rng.standard_normal((X.shape[0], 3))
    jm = lambda V: JI.kernel_mvm(jk, jnp.asarray(p), jnp.asarray(X), V, block=64)
    tm = lambda V: TI.kernel_mvm(tk, _t(p), _t(X), V, block=64)
    want = JI.cg_solve(jm, jnp.asarray(B), max_iters=200, tol=tol)
    got = TI.cg_solve(tm, _t(B), max_iters=200, tol=tol)
    assert int(got.iters) == int(want.iters) < 200
    if tol == 1e-10:
        assert _rel(got.x.numpy(), want.x) < 1e-10


def _first_stop_cg(mvm, B, max_iters, tol):
    """gpc_tpu's loop with a host test before every iteration: the
    reference the frozen-flag form must equal bit for bit."""
    X, R, P = torch.zeros_like(B), B, B
    rs = torch.sum(R * R, dim=0)
    bnorm = torch.sqrt(torch.sum(B * B, dim=0)) + 1e-300
    it = 0
    while it < max_iters and bool(torch.max(torch.sqrt(rs) / bnorm) > tol):
        Kp = mvm(P)
        alpha = rs / (torch.sum(P * Kp, dim=0) + 1e-300)
        X, R = X + P * alpha[None, :], R - Kp * alpha[None, :]
        rs_new = torch.sum(R * R, dim=0)
        P = R + P * (rs_new / (rs + 1e-300))[None, :]
        rs, it = rs_new, it + 1
    return X, torch.sqrt(rs), it


@pytest.mark.parametrize("check_every", [1, 3, 8, 64])
@pytest.mark.parametrize("tol", [1e-3, 1e-7])
def test_frozen_flag_cg_equals_first_stop(tol, check_every, monkeypatch):
    """The device flag freezes the update at the first iteration that meets
    tol, so reading it only every CHECK_EVERY iterations changes nothing:
    x, residual and count equal the first-stop loop's bit for bit."""
    jk, tk, p, X, rng = _setup()
    B = _t(rng.standard_normal((X.shape[0], 2)))
    tm = lambda V: TI.kernel_mvm(tk, _t(p), _t(X), V, block=64)
    x0, r0, it0 = _first_stop_cg(tm, B, 150, tol)
    monkeypatch.setattr(TI, "CHECK_EVERY", check_every)
    got = TI.cg_solve(tm, B, max_iters=150, tol=tol)
    assert int(got.iters) == it0 < 150
    assert torch.equal(got.x, x0) and torch.equal(got.residual, r0)


def _pivots(Lk):
    """Column i's pivot holds its largest entry (√d_piv ≥ every other)."""
    return np.argmax(np.abs(Lk), axis=0)


def test_pcg_and_pivoted_cholesky_match():
    jk, tk, p, X, rng = _setup(N=150)
    Lk_j = np.asarray(JI.pivoted_cholesky(jk, jnp.asarray(p), jnp.asarray(X), 30))
    Lk_t = TI.pivoted_cholesky(tk, _t(p), _t(X), 30).numpy()
    np.testing.assert_array_equal(_pivots(Lk_t), _pivots(Lk_j))
    np.testing.assert_allclose(Lk_t, Lk_j, rtol=0, atol=1e-12)
    B = rng.standard_normal((150, 2))
    jm = lambda V: JI.kernel_mvm(jk, jnp.asarray(p), jnp.asarray(X), V, block=64)
    tm = lambda V: TI.kernel_mvm(tk, _t(p), _t(X), V, block=64)
    sigma2 = float(p[3]) + 1e-8
    jpre = JI.woodbury_preconditioner(jnp.asarray(Lk_j), sigma2)
    tpre = TI.woodbury_preconditioner(_t(Lk_t), sigma2)
    np.testing.assert_allclose(tpre(_t(B)).numpy(), np.asarray(jpre(jnp.asarray(B))),
                               rtol=1e-10, atol=1e-10)
    want = JI.pcg_solve(jm, jnp.asarray(B), jpre, max_iters=300, tol=1e-10)
    got = TI.pcg_solve(tm, _t(B), tpre, max_iters=300, tol=1e-10)
    assert int(got.iters) == int(want.iters) < 300
    assert _rel(got.x.numpy(), want.x) < 1e-10


def test_pivoted_cholesky_masked_matches():
    jk, tk, p, X, _ = _setup(N=80)
    mask = np.ones(80)
    mask[[0, 33, 79]] = 0.0
    want = np.asarray(JI.pivoted_cholesky_masked(jk, jnp.asarray(p), jnp.asarray(X),
                                                 jnp.asarray(mask), 20))
    got = TI.pivoted_cholesky_masked(tk, _t(p), _t(X), _t(mask), 20).numpy()
    np.testing.assert_array_equal(_pivots(got), _pivots(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not got[[0, 33, 79]].any()


def test_lanczos_and_slq_match():
    """One block Lanczos over the P probe columns equals gpc_tpu's vmapped
    per-probe Lanczos; SLQ on gpc_tpu's probes equals its estimate."""
    jk, tk, p, X, _ = _setup(N=100)
    jm = lambda V: JI.kernel_mvm(jk, jnp.asarray(p), jnp.asarray(X), V, block=64)
    tm = lambda V: TI.kernel_mvm(tk, _t(p), _t(X), V, block=64)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 6)
    Z = np.stack([np.asarray(jax.random.rademacher(k, (100,), dtype=jnp.float64))
                  for k in keys], axis=1)
    a_t, b_t = TI._lanczos(tm, _t(Z), 20)
    for j in range(6):
        a_j, b_j = JI._lanczos(jm, jnp.asarray(Z[:, j]), 20)
        np.testing.assert_allclose(a_t[:, j].numpy(), np.asarray(a_j), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(b_t[:, j].numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-10)
    want = float(JI.slq_logdet(jm, 100, key, probes=6, lanczos_iters=20))
    got = float(TI.slq_logdet(tm, 100, lanczos_iters=20, Z=_t(Z)))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_iterative_evidence_matches():
    jk, tk, p, X, rng = _setup(N=128)
    m = rng.standard_normal((128, 2))
    key = jax.random.PRNGKey(1)
    keys = jax.random.split(key, 8)
    Z = np.stack([np.asarray(jax.random.rademacher(k, (128,), dtype=jnp.float64))
                  for k in keys], axis=1)
    for rank in (0, 30):
        q_j, ld_j = JI.iterative_evidence(jk, jnp.asarray(p), jnp.asarray(X), jnp.asarray(m),
                                          key, block=64, probes=8, lanczos_iters=24,
                                          precond_rank=rank)
        q_t, ld_t = TI.iterative_evidence(tk, _t(p), _t(X), _t(m), block=64, probes=8,
                                          lanczos_iters=24, precond_rank=rank, Z=_t(Z))
        np.testing.assert_allclose([float(q_t), float(ld_t)], [float(q_j), float(ld_j)],
                                   rtol=1e-8)


def _cfgs():
    kw = dict(block=48, probes=8, lanczos_iters=24, cg_iters=300, trace_probes=6, seed=5)
    return JI.IterConfig(**kw), TI.IterConfig(**kw)


@pytest.mark.parametrize("precond_rank", [0, 25])
@pytest.mark.parametrize("masked", [False, True])
def test_evidence_core_and_vjp_match(masked, precond_rank):
    """(logdet, quad) and the pullback in (p, X, m) of both cores, with
    gpc_tpu's probes, within 1e-8."""
    jk, tk, p, X, rng = _setup(N=110)
    m = rng.standard_normal((110, 2))
    cj, ct = _cfgs()
    cj, ct = cj._replace(precond_rank=precond_rank), ct._replace(precond_rank=precond_rank)
    probes = tuple(_t(z) for z in jax_probes(cj.seed, 110, cj.trace_probes, cj.probes))
    wts = np.array([0.7, -1.3])
    if masked:
        mask = np.ones(110)
        mask[[0, 41, 109]] = 0.0
        m[[0, 41, 109]] = 0.0
        jf = lambda p_, X_, m_: JI.kern_evidence_iterative_masked(
            jk, p_, X_, m_, jnp.asarray(mask), cj)
        tf = lambda p_, X_, m_: TI.kern_evidence_iterative_masked(
            tk, p_, X_, m_, _t(mask), ct, probes=probes)
    else:
        jf = lambda p_, X_, m_: JI.kern_evidence_iterative(jk, p_, X_, m_, cj)
        tf = lambda p_, X_, m_: TI.kern_evidence_iterative(tk, p_, X_, m_, ct, probes=probes)
    want = jf(jnp.asarray(p), jnp.asarray(X), jnp.asarray(m))
    wgrad = jax.grad(lambda *a: wts[0] * jf(*a)[0] + wts[1] * jf(*a)[1],
                     argnums=(0, 1, 2))(jnp.asarray(p), jnp.asarray(X), jnp.asarray(m))
    args = [_t(a).requires_grad_(True) for a in (p, X, m)]
    ld, quad = tf(*args)
    np.testing.assert_allclose([float(ld.detach()), float(quad.detach())], [float(want[0]), float(want[1])],
                               rtol=1e-8)
    got = torch.autograd.grad(wts[0] * ld + wts[1] * quad, args)
    for g, w in zip(got, wgrad):
        assert _rel(g.numpy(), w) < 1e-8


def test_make_iterative_nlml_matches():
    jk, tk, p, X, rng = _setup(N=100)
    m = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((100, 1))
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    kw = dict(block=64, probes=8, lanczos_iters=20, cg_iters=200, trace_probes=4)
    jn = JI.make_iterative_nlml(jk, X, m, key, **kw)
    tn = TI.make_iterative_nlml(tk, _t(X), _t(m), seed, **kw,
                                probe_vectors=tuple(_t(z) for z in jax_probes(seed, 100, 4, 8)))
    v, g = jax.value_and_grad(jn)(jnp.asarray(p))
    pt = _t(p).requires_grad_(True)
    f = tn(pt)
    (gt,) = torch.autograd.grad(f, pt)
    np.testing.assert_allclose(float(f), float(v), rtol=1e-8)
    assert _rel(gt.numpy(), g) < 1e-8


def test_ftc_gp_iterative_matches(monkeypatch):
    """models/gp.py FTC under GPC_TPU_EVIDENCE=iterative equals gpc_tpu's,
    value and gradient, with gpc_tpu's probes."""
    monkeypatch.setattr(TI, "rademacher_probes", lambda seed, N, T, P, dtype, device: tuple(
        torch.as_tensor(z, dtype=dtype, device=device) for z in jax_probes(seed, N, T, P)))
    for k, v in dict(GPC_TPU_EVIDENCE="iterative", GPC_TPU_ITER_BLOCK="40",
                     GPC_TPU_ITER_PROBES="8", GPC_TPU_ITER_TPROBES="4",
                     GPC_TPU_ITER_SEED="3").items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((90, 2))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((90, 1))
    jm = JGP(_kern(2), X, y)
    pm = from_jax(jm.spec.kern, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales,
                  device="cpu")
    v, g = jax.value_and_grad(jm._objective)(jm.theta)
    pv, pg = pm.value_and_grad_fn()(pm.theta)
    np.testing.assert_allclose(pv, float(v), rtol=1e-10)
    assert _rel(pg, g) < 1e-9


def test_port_probes_are_seeded_rademacher():
    """The port's own draw: ±1 entries, the same for the same seed, other
    for another; each column near zero mean."""
    a = TI.rademacher_probes(7, 4000, 3, 5, torch.float64, "cpu")
    b = TI.rademacher_probes(7, 4000, 3, 5, torch.float64, "cpu")
    c = TI.rademacher_probes(8, 4000, 3, 5, torch.float64, "cpu")
    assert [z.shape for z in a] == [(4000, 3), (4000, 5)]
    for za, zb, zc in zip(a, b, c):
        assert set(torch.unique(za).tolist()) == {-1.0, 1.0}
        assert torch.equal(za, zb) and not torch.equal(za, zc)
        assert float(torch.abs(za.mean(0)).max()) < 0.1


def test_port_draw_is_an_estimate_of_the_dense_evidence():
    """With its own probes the engine estimates the dense evidence as
    gpc_tpu's does (tests/test_iterative.py:114-120): quad to CG tolerance,
    logdet within 0.05 relative."""
    jk, tk, p, X, rng = _setup(N=256, q=3)
    m = rng.standard_normal((256, 2))
    cfg = TI.IterConfig(block=128, probes=24, lanczos_iters=40, cg_iters=500,
                        trace_probes=16, seed=3)
    ld, quad = TI.kern_evidence_iterative(tk, _t(p), _t(X), _t(m), cfg)
    K = tk.gram(_t(p), _t(X)).numpy()
    np.testing.assert_allclose(float(quad), np.trace(m.T @ np.linalg.solve(K, m)), rtol=1e-6)
    want_ld = np.linalg.slogdet(K)[1]
    assert abs(float(ld) - want_ld) / abs(want_ld) < 0.05
