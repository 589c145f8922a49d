"""The `lazy` and `iterative` engines' gradients in X against the dense
route's, on the CPU in float64, for every kernel of kernels.py.

The dense route's Gram takes its diagonal from the kernel's `diag`
(Kern.gram); the lazy engine's diagonal blocks (ops/lazy_evidence.
kern_block_fn) and the iterative engine's row blocks (ops/iterative.
_raw_mvm, _mvm_vjp_raw) do the same, so their X-gradients stay finite where
compute's own diagonal has an unbounded derivative: exp's √(d2 + tiny) at
zero distance, whose derivative there is ≈ 3e153 (gpc_tpu's engines keep
compute's diagonal, a deviation recorded in ROADMAP.md).  Each kernel that
depends on X (every leaf but white and bias, which the compounds hold)
under cmpnd(·, white) and cmpnd(·, bias, white):

  * kern_evidence_lazy (base 16, N = 64: four leaves,
    and the bias split where the kernel has a bias) against the dense
    Cholesky evidence of Kern.gram: logdet + quad to 1e-12 relative, the
    X-gradient to 1e-10 relative L2;
  * the iterative engine's blockwise MVM and its pullback (mvm_vjp, row
    blocks of 20 so that blocks straddle the diagonal at every offset)
    against Σ G∘(K·V) with K = Kern.gram under autograd: the product to
    1e-12, X̄ and p̄ to 1e-10 relative L2.

And a GP-LVM under cmpnd(exp, bias, white): the latent gradient under
GPC_TPU_EVIDENCE=lazy against dense, 1e-10 relative L2.
"""

import numpy as np
import pytest
import torch

from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.models import gplvm as TGL
from gpc_tpu_torch.ops import iterative as TI
from gpc_tpu_torch.ops import lazy_evidence as TLE

Q = 3
LEADS = ["rbf", "exp", "ratquad", "matern32", "matern52", "lin", "mlp", "poly", "linard",
         "rbfard", "mlpard", "polyard"]
FORMS = ["white", "bias_white"]


def _kern(lead, form):
    rest = ("bias", "white") if form == "bias_white" else ("white",)
    return TK.make_kern("cmpnd", Q, components=[TK.make_kern(k, Q) for k in (lead,) + rest])


def _inputs(kern, n, seed):
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.standard_normal((n, Q)))
    m = torch.tensor(rng.standard_normal((n, 2)))
    p = kern.default_params() * np.exp(0.2 * rng.standard_normal(kern.n_params))
    p[-1] = 0.3                      # white: keep K well away from singular
    return torch.tensor(p), X, m


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _dense_evidence(kern, p, X, m):
    L = torch.linalg.cholesky(kern.gram(p, X))
    v = torch.linalg.solve_triangular(L, m, upper=False)
    return 2.0 * torch.log(torch.diagonal(L)).sum() + (v * v).sum()


def _x_grad(fn, X):
    Xg = X.clone().requires_grad_(True)
    val = fn(Xg)
    (g,) = torch.autograd.grad(val, Xg)
    return float(val.detach()), g


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lead", LEADS)
def test_lazy_x_gradient_matches_dense(lead, form):
    kern = _kern(lead, form)
    p, X, m = _inputs(kern, 64, seed=LEADS.index(lead))
    val, g = _x_grad(lambda Xg: sum(TLE.kern_evidence_lazy(kern, p, Xg, m, 16)), X)
    val_d, g_d = _x_grad(lambda Xg: _dense_evidence(kern, p, Xg, m), X)
    assert torch.isfinite(g).all()
    assert abs(val - val_d) <= 1e-12 * abs(val_d)
    assert _rel(g, g_d) <= 1e-10


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lead", LEADS)
def test_iterative_mvm_and_pullback_match_dense(lead, form):
    kern = _kern(lead, form)
    p, X, _ = _inputs(kern, 64, seed=20 + LEADS.index(lead))
    rng = np.random.default_rng(7)
    V = torch.tensor(rng.standard_normal((64, 3)))
    G = torch.tensor(rng.standard_normal((64, 3)))
    got = TI.kernel_mvm(kern, p, X, V, block=20)
    assert _rel(got, kern.gram(p, X) @ V) <= 1e-12
    pbar, Xbar = TI.mvm_vjp(kern, p, X, V, G, 20)
    pd, Xd = p.clone().requires_grad_(True), X.clone().requires_grad_(True)
    pbar_d, Xbar_d = torch.autograd.grad((G * (kern.gram(pd, Xd) @ V)).sum(), (pd, Xd))
    assert torch.isfinite(Xbar).all()
    assert _rel(Xbar, Xbar_d) <= 1e-10
    assert _rel(pbar, pbar_d) <= 1e-10


def test_gplvm_latent_gradient_under_exp_matches_dense(monkeypatch):
    """cmpnd(exp, bias, white), N = 48 latents in 2-D from 3-D data: the
    objective's gradient (kernel parameters and latents) under lazy (base
    16: three leaves) against dense."""
    rng = np.random.default_rng(3)
    t = np.linspace(0, 3 * np.pi, 48)
    y = np.column_stack([np.sin(t), np.cos(t)]) @ rng.standard_normal((2, 3)) \
        + 0.05 * rng.standard_normal((48, 3))
    kern = TK.make_kern("cmpnd", 2, components=[TK.make_kern(k, 2)
                                                for k in ("exp", "bias", "white")])
    model = TGL.GPLVM(kern, y, latent_dim=2, device="cpu")
    theta = model.theta
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    v_d, g_d = model.value_and_grad_fn()(theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "16")
    v, g = model.value_and_grad_fn()(theta)
    g, g_d = torch.as_tensor(np.asarray(g)), torch.as_tensor(np.asarray(g_d))
    assert np.isfinite(np.asarray(g)).all()
    assert abs(float(v) - float(v_d)) <= 1e-12 * abs(float(v_d))
    assert _rel(g, g_d) <= 1e-10
