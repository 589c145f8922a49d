"""The `lazy` evidence engine of gpc_tpu_torch against gpc_tpu's, on the CPU.

Same numpy inputs through both packages:

  * kern_evidence_lazy for cmpnd(mlp|poly|lin, bias, white), where the
    rank-1 bias term is split off, and for cmpnd(mlp, white), which has no
    bias: float64 at N = 1024 (four 256-leaves), the value to 1e-10
    relative and its gradient in θ and X to 1e-8 (both packages take the
    same Cholesky and triangular solves, in another order); at N = 600,
    which does not split, kern_evidence under GPC_TPU_EVIDENCE=lazy warns
    and runs the dense engine;
  * evidence_left_fast under each of the port's leaf modes (False:
    Cholesky and solves; "pallas": K5's plain version here) against
    gpc_tpu's, float32, 2e-4 relative — the bound of
    tests/test_lazy_evidence.py:185-187;
  * the model path: GPC_TPU_EVIDENCE=lazy in GP.log_likelihood and its
    gradient, the fallback to dense on a size that does not split, and the
    panel setting's fallback to lazy for a kernel outside its family, each
    with gpc_tpu's warning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu.models import gp as JGPM
from gpc_tpu.ops import evidence_fast as JEF
from gpc_tpu.ops import lazy_evidence as JLE
from gpc_tpu_torch.interop.from_jax import from_jax, kern_from_desc
from gpc_tpu_torch.ops import evidence_fast as TEF
from gpc_tpu_torch.ops import evidence_mode as TEM
from gpc_tpu_torch.ops import lazy_evidence as TLE

Q = 3


def _kern(first, bias=True, degree=2.0):
    lead = {"mlp": lambda: GK.Mlp(input_dim=Q),
            "poly": lambda: GK.Poly(input_dim=Q, degree=degree),
            "lin": lambda: GK.Lin(input_dim=Q)}[first]()
    rest = (GK.Bias(input_dim=Q), GK.White(input_dim=Q)) if bias else (GK.White(input_dim=Q),)
    return GK.Cmpnd(input_dim=Q, components=(lead,) + rest)


def _inputs(kern, n, seed, D=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, Q))
    m = rng.standard_normal((n, D))
    p = kern.default_params() * np.exp(0.2 * rng.standard_normal(kern.n_params))
    p[-1] = 0.3                      # white: keep K well away from singular
    return p, X, m


CASES = [("mlp", True, 1024), ("poly", True, 1024), ("lin", True, 1024),
         ("mlp", False, 1024), ("mlp", True, 600)]


@pytest.mark.parametrize("first,bias,n", CASES)
def test_kern_evidence_lazy_matches_jax(first, bias, n, monkeypatch):
    jk = _kern(first, bias)
    tk = kern_from_desc(jk)
    assert (TLE.bias_split(tk) is None) == (JLE.bias_split(jk) is None) == (not bias)
    p, X, m = _inputs(jk, n, seed=n + len(first))

    def f_jax(p, X):
        ld, quad = JLE.kern_evidence_lazy(jk, p, X, jnp.asarray(m), force=True)
        return ld + 0.5 * quad

    v_j, (gp_j, gX_j) = jax.value_and_grad(f_jax, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(X))
    pt, Xt = torch.tensor(p, requires_grad=True), torch.tensor(X, requires_grad=True)
    if TEM.evidence_splits(n):
        ld, quad = TLE.kern_evidence_lazy(tk, pt, Xt, torch.from_numpy(m), TEM.evidence_base())
    else:
        # the dispatcher's case: lazy on a size that does not split runs dense
        monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
        with pytest.warns(UserWarning, match="falling back to dense"):
            assert TEM.resolve_engine(tk, n) == "dense"
        with pytest.warns(UserWarning, match="falling back to dense"):
            ld, quad = TEM.kern_evidence(tk, pt, Xt, torch.from_numpy(m))
    v_t = ld + 0.5 * quad
    gp_t, gX_t = torch.autograd.grad(v_t, (pt, Xt))
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-10)
    for got, want in ((gp_t, gp_j), (gX_t, gX_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())
    # and both equal the dense evidence of the gram
    K = tk.gram(pt.detach(), Xt.detach())
    L = torch.linalg.cholesky(K)
    dense = (2.0 * torch.log(torch.diagonal(L)).sum()
             + 0.5 * (torch.linalg.solve_triangular(L, torch.from_numpy(m), upper=False) ** 2).sum())
    np.testing.assert_allclose(float(v_t.detach()), float(dense), rtol=1e-10)


@pytest.mark.parametrize("leafinv,stack,bf16", [(False, True, False), ("pallas", True, False)])
def test_evidence_left_fast_leafinv_matches_jax(leafinv, stack, bf16):
    """float32, N = 1024, cmpnd(mlp, white): the port's left-looking sweep
    under each of its leaf modes against gpc_tpu's with the same leaves
    and stacked corrections (the port always stacks them, in float32)."""
    jk = _kern("mlp", bias=False)
    tk = kern_from_desc(jk)
    p, X, m = _inputs(jk, 1024, seed=5)
    p32, X32, m32 = (a.astype(np.float32) for a in (p, X, m))
    pol_j = JEF.Policy(base=256, bf16=bf16, leafinv=leafinv, stack=stack)
    ld_j, q_j = JEF.evidence_left_fast(
        JLE.kern_block_fn(jk, jnp.asarray(p32), jnp.asarray(X32)), 1024, jnp.asarray(m32), pol_j)
    pol_t = TEF.Policy(base=256, leafinv=leafinv)
    ld_t, q_t = TEF.evidence_left_fast(
        TLE.kern_block_fn(tk, torch.from_numpy(p32), torch.from_numpy(X32)), 1024,
        torch.from_numpy(m32), pol_t)
    assert ld_t.dtype == torch.float32
    assert abs(float(ld_t) - float(ld_j)) < 2e-4 * abs(float(ld_j))
    assert abs(float(q_t) - float(q_j)) < 2e-4 * abs(float(q_j))
    assert TEF.Policy() == TEF.Policy(base=256, leafinv="pallas")


def _gp_pair(first, n, seed=3):
    jk = _kern(first)
    p, X, _ = _inputs(jk, n, seed)
    y = np.sin(X[:, :1]) + 0.1 * np.random.default_rng(seed).standard_normal((n, 1))
    jm = JGPM.GP(jk, X, y)
    jm.theta = jnp.asarray(jm.spec.pack(p))
    pm = from_jax(jk, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales, device="cpu")
    return jm, pm


def test_lazy_objective_matches_jax(monkeypatch):
    """GPC_TPU_EVIDENCE=lazy in both packages: the FTC objective and its
    gradient (the training path) at N = 1024, float64."""
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    jm, pm = _gp_pair("mlp", 1024)
    obj = JGPM.make_objective(jm.spec, jm.X, jm.y, jm.bias, jm.fixed_scales)
    f_j, g_j = jax.value_and_grad(obj)(jm.theta)
    f_t, g_t = pm.value_and_grad_fn()(pm.theta)
    np.testing.assert_allclose(f_t, float(f_j), rtol=1e-10)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-8, atol=1e-10)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    np.testing.assert_allclose(pm.log_likelihood(), -f_t, rtol=1e-10)


def test_select_evidence_mode(monkeypatch):
    """resolve_engine: dense unset at any size, lazy where N splits, and
    lazy on a size that does not split warns and resolves to dense."""
    kern = kern_from_desc(_kern("mlp"))
    monkeypatch.delenv("GPC_TPU_EVIDENCE", raising=False)
    assert TEM.resolve_engine(kern, 16384) == "dense"
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    assert TEM.evidence_base() == 256 and TEM.resolve_engine(kern, 1024) == "lazy"
    for n in (512, 1000):
        with pytest.warns(UserWarning, match="falling back to dense"):
            assert TEM.resolve_engine(kern, n) == "dense"
    monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "128")
    assert TEM.evidence_splits(512) and TEM.resolve_engine(kern, 512) == "lazy"


def test_panel_falls_back_to_lazy(monkeypatch):
    """GPC_TPU_EVIDENCE=panel with cmpnd(mlp, bias, white): gpc_tpu's
    warning, then the lazy engine's value."""
    jm, pm = _gp_pair("mlp", 1024)
    theta, X, y, bias, scales = pm._args()
    _, kp, _, _ = pm.spec.unpack(theta)
    m = y - bias
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    with pytest.warns(UserWarning, match="falling back to the lazy engine"):
        assert TEM.resolve_engine(pm.spec.kern, 1024) == "lazy"
    with pytest.warns(UserWarning, match="falling back to the lazy engine"):
        got = TEM.kern_evidence(pm.spec.kern, kp, X, m)
    want = TLE.kern_evidence_lazy(pm.spec.kern, kp, X, m, TEM.evidence_base())
    assert [float(a) for a in got] == [float(a) for a in want]
    with pytest.warns(UserWarning, match="lazy"):
        ll = pm.log_likelihood()
    np.testing.assert_allclose(ll, float(jm.log_likelihood()), rtol=1e-10)
