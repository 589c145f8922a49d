"""The rbf lazy recursions, the lazy engine's switches, the blocked Cholesky
and the panel evidence entry of gpc_tpu_torch against gpc_tpu's, on the CPU.

Same numpy inputs through both packages, float64 unless said:

  * evidence_fused_lazy (right-looking) and evidence_fused_left (fully lazy
    left-looking) on rbf_block_fn at n = 768 (which halves to odd split
    shapes), their L too, and evidence_fused_lazy at odd n = 601 and 257
    (tests/test_lazy_evidence.py:196): within 1e-10 relative;
  * rbf_evidence_lazy with force=True at n = 1024 and without (the dense
    fallback on the CPU): within 1e-10; rbf_block_fn puts the ridge on
    diagonal blocks only;
  * kern_evidence_lazy under each of gpc_tpu's switches, set in the port on
    its module constants and in gpc_tpu by its environment variables:
    GPC_TPU_EVIDENCE_PRESTACK=1 and GPC_TPU_BIAS_SPLIT=0 within 1e-10,
    GPC_TPU_BF16_EVIDENCE=1 in float32 on cmpnd(rbf, bias, white) at the
    bench's signal-to-noise, within 1e-3 of gpc_tpu's bf16 value (both
    round every product's inputs to bf16 and sum in float32, in other
    orders: 2.0e-4 measured in quad, where each package is 5.3e-3 from
    float64) and within tests/test_lazy_evidence.py:189-194's 2e-3 (logdet)
    and 5e-2 (quad) of float64;  evidence_left_fast with prestack
    for each leaf mode at base 256 and 512 in float32 within 2e-4
    (tests/test_lazy_evidence.py:185-187);
  * chol_blocked.cholesky(force=True) plain, under PALLAS_BASE (leaf
    inverses) and under BF16_UPDATES (float32, within gpc_tpu's own bf16
    value's distance), and evidence_fused under PALLAS_BASE
    (tests/test_chol_blocked.py:93);
  * linalg under FAST_JITCHOL: jitchol and evidence_terms, within 1e-10;
  * evidence_panel_rbf: its plain route (float32 inputs on the CPU: the
    plain version computes in their dtype) against gpc_tpu's Pallas kernel
    in interpret mode at N = 512, b = 128, within the panel bound 2e-3
    (tests/test_chol_panel.py:35-36); gpc_tpu's shape rule and its TPU
    timing modes raise ValueError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu import linalg as JLA
from gpc_tpu.ops import chol_blocked as JCB
from gpc_tpu.ops import chol_panel as JCP
from gpc_tpu.ops import evidence_fast as JEF
from gpc_tpu.ops import lazy_evidence as JLE
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch import linalg as TLA
from gpc_tpu_torch.ops import chol_blocked as TCB
from gpc_tpu_torch.ops import chol_panel as TCP
from gpc_tpu_torch.ops import evidence_fast as TEF
from gpc_tpu_torch.ops import lazy_evidence as TLE


def _data(n, q, d, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, q)).astype(dtype), rng.standard_normal((n, d)).astype(dtype)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _spd(n, seed):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


HYP = (0.5, 1.2, 5e-2)


@pytest.mark.parametrize("engine", ["fused_lazy", "fused_left"])
def test_rbf_recursions_match_gpc_tpu(engine):
    n = 768
    X, m = _data(n, 4, 2, 3)
    jfn = getattr(JLE, f"evidence_{engine}")
    tfn = getattr(TLE, f"evidence_{engine}")
    jld, jq, jL = jfn(JLE.rbf_block_fn(jnp.asarray(X), *HYP), n, jnp.asarray(m))
    ld, quad, L = tfn(TLE.rbf_block_fn(torch.as_tensor(X), *HYP), n, torch.as_tensor(m))
    assert _rel(ld, jld) < 1e-10 and _rel(quad, jq) < 1e-10
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [601, 257])
def test_fused_lazy_odd_sizes(n):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, 2))
    K = np.exp(-0.5 * ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)) + 0.1 * np.eye(n)
    m = rng.standard_normal((n, 1))
    jld, jq, _ = JLE.evidence_fused_lazy(lambda i, j, r, c: jnp.asarray(K[i:i + r, j:j + c]),
                                         n, jnp.asarray(m))
    Kt = torch.as_tensor(K)
    ld, quad, _ = TLE.evidence_fused_lazy(lambda i, j, r, c: Kt[i:i + r, j:j + c], n,
                                          torch.as_tensor(m))
    assert _rel(ld, jld) < 1e-10 and _rel(quad, jq) < 1e-10


@pytest.mark.parametrize("force", [True, False])
def test_rbf_evidence_lazy(force):
    n = 1024
    X, m = _data(n, 5, 3, 0)
    hyp = (0.3, 1.7, 1e-2)
    jld, jq = JLE.rbf_evidence_lazy(jnp.asarray(X), jnp.asarray(m), *hyp, force=force)
    ld, quad = TLE.rbf_evidence_lazy(torch.as_tensor(X), torch.as_tensor(m), *hyp, force=force)
    assert _rel(ld, jld) < 1e-10 and _rel(quad, jq) < 1e-10


def test_rbf_block_fn_ridge_on_diagonal_blocks_only():
    X, _ = _data(768, 2, 1, 2)
    kfn = TLE.rbf_block_fn(torch.as_tensor(X), 1.0, 1.0, 0.5)
    assert torch.allclose(torch.diagonal(kfn(256, 256, 256, 256)),
                          torch.full((256,), 1.5, dtype=torch.float64))
    off = kfn(512, 256, 256, 256)
    assert float(torch.max(torch.abs(torch.diagonal(off)))) < 1.0
    want = np.asarray(JLE.rbf_block_fn(jnp.asarray(X), 1.0, 1.0, 0.5)(512, 256, 256, 256))
    np.testing.assert_allclose(off.numpy(), want, rtol=0, atol=1e-14)


def _cmpnd(mod, q):
    return mod.Cmpnd(input_dim=q, components=(mod.Rbf(input_dim=q), mod.Matern52(input_dim=q),
                                             mod.Bias(input_dim=q), mod.White(input_dim=q)))


SWITCHES = {"prestack": ("EVIDENCE_PRESTACK", "GPC_TPU_EVIDENCE_PRESTACK", True),
            "no_bias_split": ("BIAS_SPLIT", "GPC_TPU_BIAS_SPLIT", False)}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_kern_evidence_lazy_switches(switch, monkeypatch):
    attr, env, value = SWITCHES[switch]
    monkeypatch.setattr(TLE, attr, value)
    monkeypatch.setenv(env, "1" if value else "0")
    n, q = 768, 3
    X, m = _data(n, q, 2, 4)
    p = _cmpnd(GK, q).default_params()
    jld, jq = JLE.kern_evidence_lazy(_cmpnd(GK, q), jnp.asarray(p), jnp.asarray(X),
                                     jnp.asarray(m), force=True)
    ld, quad = TLE.kern_evidence_lazy(_cmpnd(TK, q), torch.as_tensor(p), torch.as_tensor(X),
                                      torch.as_tensor(m), force=True)
    assert _rel(ld, jld) < 1e-10 and _rel(quad, jq) < 1e-10


def test_kern_evidence_lazy_bf16_switch(monkeypatch):
    """The CLI's cmpnd(rbf, bias, white) at the bench's signal-to-noise
    (white 0.1, bench.py:88-94), the family gpc_tpu's bias split keeps in
    the bf16 domain."""
    monkeypatch.setattr(TLE, "BF16_EVIDENCE", True)
    monkeypatch.setenv("GPC_TPU_BF16_EVIDENCE", "1")
    n, q = 1024, 3
    X, m = _data(n, q, 2, 5, np.float32)
    kerns = [mod.Cmpnd(input_dim=q, components=(mod.Rbf(input_dim=q), mod.Bias(input_dim=q),
                                                mod.White(input_dim=q))) for mod in (GK, TK)]
    p = np.array([1.0, 1.0, 1.0, 0.1], np.float32)
    jld, jq = JLE.kern_evidence_lazy(kerns[0], jnp.asarray(p), jnp.asarray(X),
                                     jnp.asarray(m), force=True)
    ld, quad = TLE.kern_evidence_lazy(kerns[1], torch.as_tensor(p), torch.as_tensor(X),
                                      torch.as_tensor(m), force=True)
    monkeypatch.setattr(TLE, "BF16_EVIDENCE", False)
    wld, wq = TLE.kern_evidence_lazy(kerns[1], *(torch.as_tensor(a, dtype=torch.float64)
                                                 for a in (p, X, m)), force=True)
    assert _rel(ld, jld) < 1e-3 and _rel(quad, jq) < 1e-3, (ld, jld, quad, jq)
    assert _rel(ld, wld) < 2e-3 and _rel(quad, wq) < 5e-2, (ld, wld, quad, wq)


@pytest.mark.parametrize("base", [256, 512])
@pytest.mark.parametrize("leafinv", [False, "xla", "pallas"])
def test_evidence_left_fast_prestack(leafinv, base):
    n = 1024
    X, m = _data(n, 4, 2, 11, np.float32)
    jl, jq = JEF.evidence_left_fast(JLE.rbf_block_fn(jnp.asarray(X), 1.0, 1.0, 0.1), n,
                                    jnp.asarray(m),
                                    JEF.Policy(base, False, leafinv, True, prestack=True))
    ld, quad = TEF.evidence_left_fast(TLE.rbf_block_fn(torch.as_tensor(X), 1.0, 1.0, 0.1), n,
                                      torch.as_tensor(m),
                                      TEF.Policy(base, False, leafinv, True, prestack=True))
    assert _rel(ld, jl) < 2e-4 and _rel(quad, jq) < 2e-4


@pytest.mark.parametrize("pallas_base", [False, True])
def test_cholesky_and_evidence_fused(pallas_base, monkeypatch):
    monkeypatch.setattr(TCB, "PALLAS_BASE", pallas_base)
    N, D = 768, 2
    K = _spd(N, 13)
    m = np.random.default_rng(13).standard_normal((N, D))
    L = TCB.cholesky(torch.as_tensor(K), force=True).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-9, atol=1e-9)
    assert np.all(np.triu(L, 1) == 0.0)
    logdet, quad, _ = TCB.evidence_fused(torch.as_tensor(K), torch.as_tensor(m), force=True)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(K)[1], rtol=1e-9)
    np.testing.assert_allclose(float(quad), np.trace(m.T @ np.linalg.solve(K, m)), rtol=1e-8)
    monkeypatch.setattr(JCB, "PALLAS_BASE", pallas_base)
    jld, jq, _ = JCB.evidence_fused(jnp.asarray(K), jnp.asarray(m), force=True)
    tol = 1e-6 if pallas_base else 1e-10   # gpc_tpu's interpret-mode leaf: ~1e-7 in float64
    assert _rel(logdet, jld) < tol and _rel(quad, jq) < tol


def test_cholesky_bf16_updates(monkeypatch):
    monkeypatch.setattr(TCB, "BF16_UPDATES", True)
    monkeypatch.setattr(JCB, "BF16_UPDATES", True)
    K = _spd(1024, 14).astype(np.float32)
    L = TCB.cholesky(torch.as_tensor(K), force=True).numpy()
    jL = np.asarray(JCB.cholesky(jnp.asarray(K), force=True))
    want = np.linalg.cholesky(K.astype(np.float64))
    err, jerr = np.abs(L - want).max(), np.abs(jL - want).max()
    assert err < 2 * jerr + 1e-6, (err, jerr)
    np.testing.assert_allclose(L, jL, rtol=0, atol=4 * jerr)


def test_fast_jitchol(monkeypatch):
    monkeypatch.setattr(TLA, "FAST_JITCHOL", True)
    monkeypatch.setattr(JLA, "FAST_JITCHOL", True)
    A = _spd(40, 2)
    m = np.random.default_rng(3).standard_normal((40, 2))
    L, jit = TLA.jitchol(torch.as_tensor(A))
    jL, jjit = JLA.jitchol(jnp.asarray(A))
    assert float(jit) == pytest.approx(float(jjit), rel=1e-14) and float(jit) > 0.0
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-12, atol=1e-12)
    ld, quad, _ = TLA.evidence_terms(torch.as_tensor(A), torch.as_tensor(m))
    jld, jq, _ = JLA.evidence_terms(jnp.asarray(A), jnp.asarray(m))
    assert _rel(ld, jld) < 1e-10 and _rel(quad, jq) < 1e-10


def test_evidence_panel_rbf_matches_interpret_mode():
    N = 512
    X, m = _data(N, 8, 2, 6, np.float32)
    jld, jq = JCP.evidence_panel_rbf(jnp.asarray(X), jnp.asarray(m), jnp.float32(1.0),
                                     jnp.float32(1.0), jnp.float32(0.1), b=128, interpret=True)
    ld, quad = TCP.evidence_panel_rbf(torch.as_tensor(X), torch.as_tensor(m), 1.0, 1.0, 0.1,
                                      b=128)
    assert _rel(ld, jld) < 2e-3 and _rel(quad, jq) < 2e-3


@pytest.mark.parametrize("N,b,mode", [(1920, 128, "full"), (512, 256, "full"),
                                      (512, 128, "nodot"), (512, 128, "full+leaf256")])
def test_evidence_panel_rbf_refuses(N, b, mode):
    X, m = _data(N, 8, 1, 7, np.float32)
    with pytest.raises(ValueError):
        TCP.evidence_panel_rbf(torch.as_tensor(X), torch.as_tensor(m), 1.0, 1.0, 0.1, b=b,
                               mode=mode)
