"""The port's kernel zoo (gpc_tpu_torch/kernels.py) against gpc_tpu.kernels.

Every leaf kind, `tensor` and a `cmpnd` of leaves: compute, diag, gram,
white, default parameters, transform codes, display names and the
stationary flag, in float64 from the same numpy inputs at non-default
parameters, rtol 1e-12 and atol 1e-14 (the same arithmetic; K1 and K4 run
their plain versions on the CPU).  The port's kernels are rebuilt from
gpc_tpu's through interop.from_jax.kern_from_desc, so the structural map
(poly's degree, tensor) is tested with them.

The mlp clamp: gpc_tpu's Mlp/Mlpard clamp the arcsin argument to
±(1 − epsneg), not to ±1 as its Pallas tile does, so the gradient stays
finite where w·‖x‖² passes the mantissa and the argument rounds to 1.  The
port's K4 plain version keeps gpc_tpu's clamp: at w = 1e17 in float64 its
value is within 1e-8 of gpc_tpu's and its gradient is finite and within
1e-7 of jax.grad's, where a ±1 clip gives a non-finite gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu import transforms as JT
from gpc_tpu_torch.interop.from_jax import kern_from_desc
from gpc_tpu_torch.ops import gram as TG

Q = 3


def _jax_kern(kind):
    if kind == "whitefixed":
        return GK.WhiteFixed(input_dim=Q, fixed_variance=0.05)
    if kind in ("poly", "polyard"):
        return GK.make_kern(kind, Q, degree=3.0)
    if kind == "tensor":
        return GK.Tensor(input_dim=Q, components=(
            GK.Rbf(input_dim=Q), GK.Poly(input_dim=Q, degree=3.0), GK.Linard(input_dim=Q)))
    if kind == "cmpnd":
        return GK.Cmpnd(input_dim=Q, components=(
            GK.Mlpard(input_dim=Q), GK.Matern32(input_dim=Q), GK.Bias(input_dim=Q),
            GK.White(input_dim=Q), GK.WhiteFixed(input_dim=Q, fixed_variance=0.05)))
    return GK.make_kern(kind, Q)


KINDS = ["white", "whitefixed", "bias", "rbf", "exp", "ratquad", "matern32", "matern52",
         "lin", "mlp", "poly", "linard", "rbfard", "mlpard", "polyard", "tensor", "cmpnd"]


def _params(kern, rng):
    """Non-default constrained parameters: positive ones scaled by
    exp(0.3·ε), ARD scales (sigmoid) drawn from [0.2, 0.9]."""
    p = kern.default_params() * np.exp(0.3 * rng.standard_normal(kern.n_params))
    sig = kern.transform_codes() == JT.SIGMOID
    p[sig] = rng.uniform(0.2, 0.9, int(sig.sum()))
    return p


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    jk = _jax_kern(kind)
    tk = kern_from_desc(jk)
    assert tk.kind == jk.kind and tk.n_params == jk.n_params
    assert tk.stationary == jk.stationary
    assert tk.display_names() == jk.display_names()
    np.testing.assert_array_equal(tk.default_params(), jk.default_params())
    np.testing.assert_array_equal(tk.transform_codes(), jk.transform_codes())
    if kind in ("poly", "polyard"):
        assert tk.degree == 3.0
    p = _params(jk, rng)
    X1, X2 = rng.standard_normal((7, Q)), rng.standard_normal((5, Q))
    pj, X1j, X2j = jnp.asarray(p), jnp.asarray(X1), jnp.asarray(X2)
    pt, X1t, X2t = torch.from_numpy(p), torch.from_numpy(X1), torch.from_numpy(X2)
    for got, want in ((tk.compute(pt, X1t, X2t), jk.compute(pj, X1j, X2j)),
                      (tk.diag(pt, X1t), jk.diag(pj, X1j)),
                      (tk.gram(pt, X1t), jk.gram(pj, X1j)),
                      (tk.white(pt), jk.white(pj))):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_tensor_rejects_white():
    from gpc_tpu_torch import kernels as TK
    with pytest.raises(ValueError, match="white"):
        TK.Tensor(input_dim=2, components=(TK.Rbf(input_dim=2), TK.White(input_dim=2)))
    with pytest.raises(ValueError, match="Unknown kernel type"):
        TK.make_kern("bogus", 2)


@pytest.mark.parametrize("kind", ["mlp", "mlpard"])
def test_mlp_clamp_large_weight_matches_jax(kind):
    """w = 1e17 in float64: w·‖x‖² passes the mantissa, the arcsin argument
    of every diagonal entry rounds to 1.0, and only gpc_tpu's clamp
    ±(1 − epsneg) keeps arcsin′ finite.  The port's value and gradient (in p
    and X, through compute and diag) agree with gpc_tpu's and jax.grad's."""
    rng = np.random.default_rng(31)
    jk = GK.make_kern(kind, Q)
    tk = kern_from_desc(jk)
    p = jk.default_params()
    p[0] = 1e17
    X = rng.standard_normal((6, Q))
    W = rng.standard_normal((6, 6))

    def f_jax(p, X):
        return jnp.sum(W * jk.gram(p, X)) + jnp.sum(jk.compute(p, X, X))

    v_j, (gp_j, gX_j) = jax.value_and_grad(f_jax, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(X))
    pt = torch.tensor(p, requires_grad=True)
    Xt = torch.tensor(X, requires_grad=True)
    v_t = torch.sum(torch.from_numpy(W) * tk.gram(pt, Xt)) + torch.sum(tk.compute(pt, Xt, Xt))
    gp_t, gX_t = torch.autograd.grad(v_t, (pt, Xt))
    assert bool(torch.isfinite(gp_t).all() and torch.isfinite(gX_t).all())
    # w ≈ 1e17 amplifies rounding: mlpard's (X·√s)(X·√s)ᵀ rounds other than
    # gpc_tpu's (X·s)Xᵀ (7e-10 on the value), and the gradient cancels terms
    # of order w·x·x' down to order 1 (a few 1e-9 between the packages)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-8)
    for got, want in ((gp_t, gp_j), (gX_t, gX_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7,
                                   atol=1e-12 * np.abs(want).max())

    # the Pallas tile's ±1 clip on the same inputs: arcsin′(1) = ∞
    Xc = torch.tensor(X, requires_grad=True)
    w = torch.tensor(1e17, dtype=torch.float64)
    nrm = w * torch.sum(Xc * Xc, dim=1) + p[1] + 1.0
    arg = (w * (Xc @ Xc.T) + p[1]) / torch.sqrt(nrm[:, None] * nrm[None, :])
    (g_clip,) = torch.autograd.grad(torch.asin(torch.clamp(arg, -1.0, 1.0)).sum(), Xc)
    assert not bool(torch.isfinite(g_clip).all())
    # and K4's plain version on the same inputs stays finite
    (g_k4,) = torch.autograd.grad(TG.inner_gram_plain("mlp", [1e17, p[1], 1.0], Xt, Xt).sum(), Xt)
    assert bool(torch.isfinite(g_k4).all())


def test_poly_degree_round_trip(tmp_path):
    """A degree-3 poly inside a cmpnd crosses from gpc_tpu to the port with
    its degree (from_jax and model files, both ways), and a tensor does
    too: the two packages write the same file, read each other's, and give
    the same log-likelihood (float64, 1e-10)."""
    from gpc_tpu.io import model_io as JIO
    from gpc_tpu.models.gp import GP as JGP
    from gpc_tpu_torch.interop.from_jax import from_jax
    from gpc_tpu_torch.io import model_io as TIO
    rng = np.random.default_rng(41)
    X = 0.5 * rng.standard_normal((40, Q))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((40, 1))
    jk = GK.Cmpnd(input_dim=Q, components=(
        GK.Poly(input_dim=Q, degree=3.0),
        GK.Tensor(input_dim=Q, components=(GK.Polyard(input_dim=Q, degree=3.0),
                                           GK.Rbf(input_dim=Q))),
        GK.Bias(input_dim=Q), GK.White(input_dim=Q)))
    jm = JGP(jk, X, y)
    pm = from_jax(jk, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales, device="cpu")
    degrees = lambda k: [k.components[0].degree, k.components[1].components[0].degree]
    assert degrees(pm.spec.kern) == [3.0, 3.0]
    JIO.write_gp(tmp_path / "j", jm)
    TIO.write_gp(tmp_path / "t", pm)
    assert (tmp_path / "j").read_text() == (tmp_path / "t").read_text()
    assert "degree=3\n" in (tmp_path / "t").read_text()
    back_t = TIO.read_gp(tmp_path / "j", X=X, y=y, device="cpu")
    back_j = JIO.read_gp(str(tmp_path / "t"), X=X, y=y)
    assert degrees(back_t.spec.kern) == degrees(back_j.spec.kern) == [3.0, 3.0]
    want = float(jm.log_likelihood())
    for got in (pm.log_likelihood(), back_t.log_likelihood(), float(back_j.log_likelihood())):
        np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_get_set_variance_match_jax(kind):
    """get_variance and set_variance (the GPDM's SNR scaling) equal
    gpc_tpu's within 1e-12 for every kind; whitefixed, and a tensor holding
    it, raise as gpc_tpu's do."""
    rng = np.random.default_rng(13)
    jk = _jax_kern(kind)
    tk = kern_from_desc(jk)
    p = _params(jk, rng)
    pj, pt = jnp.asarray(p), torch.as_tensor(p)
    np.testing.assert_allclose(float(tk.get_variance(pt)), float(jk.get_variance(pj)),
                               rtol=1e-12)
    if kind == "whitefixed":
        with pytest.raises(ValueError, match="structural"):
            tk.set_variance(pt, 0.7)
        return
    got = tk.set_variance(pt, 0.7).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.set_variance(pj, 0.7)), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(pt.numpy(), p)        # out of place
    if kind != "tensor":        # a tensor's product lands on total·(val/total)^k
        np.testing.assert_allclose(float(tk.get_variance(torch.as_tensor(got))), 0.7,
                                   rtol=1e-12)


def test_tensor_with_whitefixed_raises_as_jax():
    jk = GK.Tensor(input_dim=Q, components=(GK.Rbf(input_dim=Q),
                                           GK.WhiteFixed(input_dim=Q, fixed_variance=0.1)))
    tk = kern_from_desc(jk)
    p = np.array([1.2, 0.8])
    with pytest.raises(ValueError, match="structural"):
        jk.set_variance(jnp.asarray(p), 0.5)
    with pytest.raises(ValueError, match="structural"):
        tk.set_variance(torch.as_tensor(p), 0.5)


@pytest.mark.parametrize("case", ["fixed_holds_all", "below_fixed"])
def test_cmpnd_set_variance_raises_where_jax_breaks_down(case):
    """Where gpc_tpu's ratio (val − fixed)/(cur − fixed) gives NaN (the
    whitefixed children hold all the variance) or negative variances
    (val < fixed), the port raises ValueError."""
    wf = GK.WhiteFixed(input_dim=Q, fixed_variance=0.2)
    if case == "fixed_holds_all":
        jk = GK.Cmpnd(input_dim=Q, components=(wf,))
        p, val, match = np.zeros(0), 0.2, "hold all"
    else:
        jk = GK.Cmpnd(input_dim=Q, components=(GK.Rbf(input_dim=Q), wf))
        p, val, match = np.array([1.0, 0.5]), 0.1, "below"
    out = np.asarray(jk.set_variance(jnp.asarray(p), val))
    assert np.isnan(out).any() or (out < 0).any() or out.size == 0
    with pytest.raises(ValueError, match=match):
        kern_from_desc(jk).set_variance(torch.as_tensor(p), val)
