"""The port's erfcx family (gpc_tpu_torch/ndlutil.py) and noise models
(gpc_tpu_torch/noise.py) against gpc_tpu's.

The same numpy inputs go through both packages in float64.  Every function
of the ndlutil family agrees within rtol 1e-12 (atol 1e-300 where a value
underflows), on grids that reach |u| = 40 in the tails: the same branch
structure, with torch's and XLA's erf/erfc/ndtri differing in their last
bits (where a function cancels, the test says by how much it may grow).  The float32 erfcx agrees with gpc_tpu's float32 within 1e-6
relative (the same asymptotic switch at 5; float32 rounding).  Every method
of the five noise models (log_likelihood, grad_inputs, nu_g, update_sites,
out, likelihoods, test_metric, default_params) agrees within rtol 1e-12,
with posterior means spread to ±40 posterior standard deviations (ν
relative to its terms, which cancel in the tails); the
noise-parameter gradient of log_likelihood from autograd agrees with
jax.grad within rtol 1e-10 (the sums' order differs) and is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import ndlutil as JN
from gpc_tpu import noise as JZ
from gpc_tpu_torch import ndlutil as TN
from gpc_tpu_torch import noise as TZ

RTOL = 1e-12
TAIL = np.concatenate([np.linspace(-40.0, 40.0, 801), [-26.5, -25.0, -5.0, 0.0, 5.0, 25.0]])


def _close(got, want, rtol=RTOL, atol=1e-300):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


UNARY = ["erfcx", "ngaussian", "cum_gaussian", "grad_ln_cum_gaussian", "ln_cum_gaussian",
         "sigmoid", "gammaln", "digamma"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_functions_match_jax(name):
    x = TAIL
    if name in ("gammaln", "digamma"):
        x = np.abs(TAIL) + 0.05
    _close(getattr(TN, name)(_t(x)), getattr(JN, name)(jnp.asarray(x)))


def test_inverse_and_gamma_functions_match_jax():
    p = np.concatenate([np.logspace(-300, -1, 60), np.linspace(0.05, 0.95, 19),
                        1.0 - np.logspace(-15, -2, 20)])
    _close(TN.inv_cum_gaussian(_t(p)), JN.inv_cum_gaussian(jnp.asarray(p)))
    _close(TN.erfcinv(_t(2 * p)), JN.erfcinv(jnp.asarray(2 * p)))
    # log(p) − log1p(−p) cancels to 0 at p = 0.5, where one ulp of log is 1.1e-16
    _close(TN.inv_sigmoid(_t(p)), JN.inv_sigmoid(jnp.asarray(p)), atol=1e-15)
    x = np.linspace(0.1, 30.0, 50)
    _close(TN.gamma(_t(x)), JN.gamma(jnp.asarray(x)))
    a = np.array([0.0, 0.0, 1.5, 2.0, -1.0])
    b = np.array([0.0, 3.0, 2.5, 1e-300, 4.0])
    _close(TN.xlogy(_t(a), _t(b)), JN.xlogy(jnp.asarray(a), jnp.asarray(b)))
    # Python numbers are float64, as under JAX x64
    assert TN.inv_cum_gaussian(0.3).dtype == torch.float64


@pytest.mark.parametrize("gap", [0.5, 2.0, 6.0, 1e-3])
def test_two_argument_functions_match_jax(gap):
    """Φ(u) − Φ(u − gap) cancels: the erfc's last-bit differences grow by
    up to |u|/gap, so the narrowest gap (1e-3, reaching |u| = 40) is held
    at rtol 1e-9."""
    u = TAIL
    up = u - gap
    rtol = RTOL if gap >= 0.5 else 1e-9
    for order in (1, 2):
        _close(TN.gauss_over_diff_cum_gaussian(_t(u), _t(up), order),
               JN.gauss_over_diff_cum_gaussian(jnp.asarray(u), jnp.asarray(up), order), rtol)
    _close(TN.ln_diff_cum_gaussian(_t(u), _t(up)),
           JN.ln_diff_cum_gaussian(jnp.asarray(u), jnp.asarray(up)), rtol)
    for w1, w2 in ((0.3, 0.7), (1e-6, 0.5), (0.5, 0.5)):
        _close(TN.ln_cum_gauss_sum(_t(-u), _t(up), _t(w1), _t(w2)),
               JN.ln_cum_gauss_sum(jnp.asarray(-u), jnp.asarray(up), w1, w2))
    with pytest.raises(ValueError, match="order must be 1 or 2"):
        TN.gauss_over_diff_cum_gaussian(_t(u), _t(up), 3)


def test_erfcx_float32_matches_jax_float32():
    """erfcx's asymptotic switch is at 5 in float32 (25 in float64)."""
    x = np.concatenate([np.linspace(-9.0, 30.0, 3901), [4.999, 5.0, 5.001]]).astype(np.float32)
    got = TN.erfcx(torch.as_tensor(x))
    assert got.dtype == torch.float32
    want = np.asarray(JN.erfcx(jnp.asarray(x)))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # ROBUSTADD rounds to 0 in float32, as in gpc_tpu's float32
    assert float(torch.tensor(0.0, dtype=torch.float32) + TN.ROBUSTADD) == 0.0


def _noises():
    return {
        "gaussian": (JZ.GaussianNoise(output_dim=2), TZ.GaussianNoise(output_dim=2)),
        "probit": (JZ.ProbitNoise(output_dim=2), TZ.ProbitNoise(output_dim=2)),
        "ncnm": (JZ.NcnmNoise(output_dim=2), TZ.NcnmNoise(output_dim=2)),
        "ncnm_split": (JZ.NcnmNoise(output_dim=2, split_gamma=True),
                       TZ.NcnmNoise(output_dim=2, split_gamma=True)),
        "ordered3": (JZ.OrderedNoise(output_dim=2), TZ.OrderedNoise(output_dim=2)),
        "ordered5": (JZ.OrderedNoise(output_dim=2, num_categories=5),
                     TZ.OrderedNoise(output_dim=2, num_categories=5)),
    }


def _moments(kind, rng, N=240):
    """(p, mu, varsigma, y): mu spread to ±40 posterior standard deviations."""
    vs = np.exp(rng.uniform(-4.0, 1.0, (N, 2)))
    mu = rng.uniform(-40.0, 40.0, (N, 2)) * np.sqrt(vs + 1e-6)
    mu[:40] = rng.standard_normal((40, 2))
    if kind == "gaussian":
        y = rng.standard_normal((N, 2))
        p = np.array([0.3, -0.2, 0.05])
    elif kind == "probit":
        y = np.where(rng.uniform(size=(N, 2)) < 0.5, 1.0, -1.0)
        p = np.array([0.4, -0.3])
    elif kind.startswith("ncnm"):
        y = rng.choice([1.0, -1.0, 0.0, np.nan], size=(N, 2))
        p = np.array([0.2, -0.1, 0.3] + ([0.6] if kind == "ncnm_split" else []))
    else:
        C = 3 if kind == "ordered3" else 5
        y = rng.integers(0, C, (N, 2)).astype(float)
        y[rng.uniform(size=(N, 2)) < 0.1] = np.nan
        mu = mu / 10.0
        p = np.concatenate([[0.3, -0.5], np.linspace(0.5, 1.5, C - 2)])
    return p, mu, vs, y


@pytest.mark.parametrize("kind", list(_noises()))
def test_noise_methods_match_jax(kind):
    jn, tn = _noises()[kind]
    rng = np.random.default_rng(len(kind))
    p, mu, vs, y = _moments(kind, rng)
    J = [jnp.asarray(a) for a in (p, mu, vs, y)]
    T = [_t(a) for a in (p, mu, vs, y)]
    assert (tn.kind, tn.n_params, tn.log_concave, tn.spherical, tn.missing,
            tn.sigma2_fixed) == (jn.kind, jn.n_params, jn.log_concave, jn.spherical,
                                 jn.missing, jn.sigma2_fixed)
    np.testing.assert_array_equal(tn.transform_codes(), jn.transform_codes())
    y_fin = np.where(np.isnan(y), 0.0, y) if kind.startswith("ordered") else y
    for data in (None, y_fin):
        np.testing.assert_allclose(tn.default_params(data), jn.default_params(data), rtol=RTOL)
    _close(tn.log_likelihood(*T), jn.log_likelihood(*J))
    for got, want in zip(tn.grad_inputs(*T), jn.grad_inputs(*J)):
        _close(got, want)
    nu_t, g_t = tn.nu_g(*T)
    nu_j, g_j = jn.nu_g(*J)
    _close(g_t, g_j)
    # ν = g_mu² − 2·g_vs cancels in the tails (by ≈ u² at u = 40): held
    # within 1e-12 of the size of its two terms
    gmu, gvs = (np.asarray(a) for a in jn.grad_inputs(*J))
    scale = np.maximum(gmu * gmu + 2.0 * np.abs(gvs), np.abs(np.asarray(nu_j)))
    assert np.all(np.abs(nu_t.numpy() - np.asarray(nu_j)) <= RTOL * scale)
    # update_sites on the same ν and g
    for got, want in zip(tn.update_sites(*T, _t(nu_j), _t(g_j)),
                         jn.update_sites(*J, nu_j, g_j)):
        _close(got, want)
    _close(tn.out(*T[:3]), jn.out(*J[:3]))
    if hasattr(jn, "likelihoods") and not kind.startswith("ordered"):
        _close(tn.likelihoods(*T), jn.likelihoods(*J))
    if kind in ("gaussian", "probit"):
        _close(tn.test_metric(*T), jn.test_metric(*J))
    if kind == "gaussian":
        _close(tn.out_std(*T[:3]), jn.out_std(*J[:3]))


@pytest.mark.parametrize("kind", list(_noises()))
def test_noise_parameter_gradients_match_jax(kind):
    """∂ log_likelihood / ∂p: autograd against jax.grad, finite."""
    jn, tn = _noises()[kind]
    p, mu, vs, y = _moments(kind, np.random.default_rng(7 + len(kind)))
    want = np.asarray(jax.grad(lambda q: jn.log_likelihood(
        q, jnp.asarray(mu), jnp.asarray(vs), jnp.asarray(y)))(jnp.asarray(p)))
    pt = _t(p).requires_grad_(True)
    (got,) = torch.autograd.grad(tn.log_likelihood(pt, _t(mu), _t(vs), _t(y)), pt)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_scale_noise_and_factory_match_jax():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((30, 2))
    jn, tn = JZ.ScaleNoise(output_dim=2), TZ.ScaleNoise(output_dim=2)
    np.testing.assert_allclose(tn.default_params(y), jn.default_params(y), rtol=RTOL)
    p = np.array([0.3, -1.0, 2.0, 0.5])
    mu = rng.standard_normal((30, 2))
    _close(tn.out(_t(p), _t(mu), None), jn.out(jnp.asarray(p), jnp.asarray(mu), None))
    assert (tn.kind, tn.n_params, tn.spherical) == ("scale", 4, True)
    for kind, kwargs in (("ncnm", {"split_gamma": True}), ("ordered", {"num_categories": 4}),
                         ("probit", {}), ("gaussian", {})):
        assert TZ.make_noise(kind, 3, **kwargs) == type(TZ.make_noise(kind, 3, **kwargs))(
            output_dim=3, **kwargs)
    with pytest.raises(ValueError, match="Unknown noise model"):
        TZ.make_noise("bogus", 1)


def test_nu_g_clamp_order_matches_jax():
    """A negative ν of the non-log-concave NCNM becomes SMALLVAL and stays;
    a tiny positive ν becomes EPS (CNoise.cpp:19-33)."""
    jn, tn = JZ.NcnmNoise(output_dim=1), TZ.NcnmNoise(output_dim=1)
    mu = np.linspace(-3.0, 3.0, 61).reshape(-1, 1)
    vs = np.full_like(mu, 4.0)
    y = np.zeros_like(mu)
    p = np.array([0.0, 0.5])
    nu_t, _ = tn.nu_g(_t(p), _t(mu), _t(vs), _t(y))
    nu_j, _ = jn.nu_g(*(jnp.asarray(a) for a in (p, mu, vs, y)))
    _close(nu_t, nu_j)
    assert (nu_t.numpy() == TZ.SMALLVAL).any()
