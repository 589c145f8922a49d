"""The plain reference against NumPy closed forms at small N, and the SCG
replay against the program's SCG (the comparison with the port is made
here, never in the reference)."""

import math

import numpy as np
import pytest
import torch

from harness.spec import module
from conftest import ROOT

ref = module(ROOT, "reference", "gp")
scg_ref = module(ROOT, "reference", "scg")

FTC = {"approx": "ftc", "N": 40, "q": 3, "D": 1, "M": 0,
       "precision": {"factor": "bf16", "products": "f32", "serving": "f32"}}
DTC = {"approx": "dtc", "N": 40, "q": 3, "D": 1, "M": 6,
       "precision": {"factor": "f32", "products": "f32", "serving": "f32"}}


def _data(seed=0, n=40, q=3):
    g = np.random.default_rng(seed)
    X = g.standard_normal((n, q))
    return X, np.sin(X.sum(1, keepdims=True)) + 0.1 * g.standard_normal((n, 1)), g


def _rbf(A, B, gam, s2):
    d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
    return s2 * np.exp(-0.5 * gam * d2)


def _np_ftc_nlml(X, y, th):
    gam, s2, b, w = np.exp(th)
    m = y - y.mean(0)
    K = _rbf(X, X, gam, s2) + b + w * np.eye(len(X))
    return 0.5 * (m.T @ np.linalg.solve(K, m)).item() + 0.5 * np.linalg.slogdet(K)[1] \
        + 0.5 * len(X) * math.log(2 * math.pi)


def _np_dtc_parts(X, y, th, M, q):
    Xu = th[:M * q].reshape(q, M).T
    gam, s2, b, w, beta = np.exp(th[M * q:])
    Kuu = _rbf(Xu, Xu, gam, s2) + b + w * np.eye(M)
    Kuf = _rbf(Xu, X, gam, s2) + b
    return Xu, (gam, s2, b, w, beta), Kuu, Kuf


def _np_dtc_nlml(X, y, th, M, q):
    """y ~ N(0, K_fu K_uu⁻¹ K_uf + β⁻¹I), the N × N form."""
    _, (_, _, _, _, beta), Kuu, Kuf = _np_dtc_parts(X, y, th, M, q)
    m = y - y.mean(0)
    S = Kuf.T @ np.linalg.solve(Kuu, Kuf) + np.eye(len(X)) / beta
    return 0.5 * (m.T @ np.linalg.solve(S, m)).item() + 0.5 * np.linalg.slogdet(S)[1] \
        + 0.5 * len(X) * math.log(2 * math.pi)


def _fd(f, th, idx, h=1e-5):
    out = []
    for i in idx:
        e = np.zeros_like(th)
        e[i] = h
        out.append((f(th + e) - f(th - e)) / (2 * h))
    return np.array(out)


def test_ftc_nlml_and_gradient_match_the_closed_form():
    X, y, g = _data()
    th = np.array([0.3, -0.2, -1.5, -2.3]) + 0.1 * g.standard_normal(4)
    f, grad = ref.nlml_and_grad(FTC, X, y, th)
    assert f == pytest.approx(_np_ftc_nlml(X, y, th), rel=1e-12)
    np.testing.assert_allclose(grad, _fd(lambda t: _np_ftc_nlml(X, y, t), th, range(4)),
                               rtol=1e-6, atol=1e-8)


def test_dtc_nlml_and_gradient_match_the_closed_form():
    X, y, g = _data(1)
    M, q = DTC["M"], DTC["q"]
    Xu = X[g.choice(len(X), M, replace=False)]
    th = np.concatenate([Xu.T.ravel(), [0.2, 0.1, -2.0, -1.8, 0.4]])
    f, grad = ref.nlml_and_grad(DTC, X, y, th)
    assert f == pytest.approx(_np_dtc_nlml(X, y, th, M, q), rel=1e-11)
    idx = [0, 7, M * q - 1] + list(range(M * q, M * q + 5))
    np.testing.assert_allclose(grad[idx], _fd(lambda t: _np_dtc_nlml(X, y, t, M, q), th, idx),
                               rtol=1e-5, atol=1e-7)


def test_ftc_posterior_matches_the_closed_form():
    X, y, g = _data(2)
    th = np.array([0.1, 0.2, -2.0, -2.0])
    Xt = g.standard_normal((9, 3))
    mu, var = ref.posterior(ref.posterior_state(FTC, X, y, th), Xt)
    gam, s2, b, w = np.exp(th)
    K = _rbf(X, X, gam, s2) + b + w * np.eye(len(X))
    Ks = _rbf(X, Xt, gam, s2) + b
    want_mu = Ks.T @ np.linalg.solve(K, y - y.mean(0)) + y.mean(0)
    want_var = s2 + b + w - np.einsum("ij,ij->j", Ks, np.linalg.solve(K, Ks))
    np.testing.assert_allclose(mu, want_mu, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var[:, 0], want_var, rtol=1e-10, atol=1e-12)


def test_dtc_posterior_matches_the_projected_process_closed_form():
    """Rasmussen & Williams 2006, eq. 8.26-8.27, plus the noise 1/β of y*."""
    X, y, g = _data(3)
    M, q = DTC["M"], DTC["q"]
    th = np.concatenate([X[:M].T.ravel(), [0.2, 0.1, -2.0, -1.8, 0.4]])
    Xt = g.standard_normal((7, 3))
    mu, var = ref.posterior(ref.posterior_state(DTC, X, y, th), Xt)
    Xu, (gam, s2, b, w, beta), Kuu, Kuf = _np_dtc_parts(X, y, th, M, q)
    Ksu = _rbf(Xt, Xu, gam, s2) + b
    Qsf = Ksu @ np.linalg.solve(Kuu, Kuf)
    S = Kuf.T @ np.linalg.solve(Kuu, Kuf) + np.eye(len(X)) / beta
    want_mu = Qsf @ np.linalg.solve(S, y - y.mean(0)) + y.mean(0)
    Qss = np.einsum("ij,ji->i", Ksu, np.linalg.solve(Kuu, Ksu.T))
    A = Kuu / beta + Kuf @ Kuf.T
    want_var = s2 + b + w - Qss + np.einsum("ij,ji->i", Ksu, np.linalg.solve(A, Ksu.T)) / beta \
        + 1 / beta
    np.testing.assert_allclose(mu, want_mu, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var[:, 0], want_var, rtol=1e-9, atol=1e-11)


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -10, -(one + 3 * 2 ** -11),
                      one + 2 ** -11 + 2 ** -20], dtype=torch.float32)
    want = [one, one + 2 ** -9, one + 2 ** -10, -(one + 2 ** -9), one + 2 ** -10]
    assert ref.tf32(x).tolist() == want


@pytest.mark.parametrize("cfg", [FTC, DTC], ids=["ftc", "dtc"])
def test_the_control_departs_from_float64(cfg):
    X, y, g = _data(4)
    th = np.array([0.1, 0.2, -2.0, -2.0])
    if cfg["approx"] == "dtc":
        th = np.concatenate([X[:cfg["M"]].T.ravel(), th, [0.0]])
    f, _ = ref.nlml_and_grad(cfg, X, y, th)
    fc, _ = ref.nlml_and_grad(cfg, X, y, th, precision="control")
    assert 1e-7 < abs(fc - f) / abs(f)


def _program_scg_run(iters=8, frozen=False):
    """The program's SCG on the program's FTC objective (CPU, float64),
    recording each evaluation."""
    import importlib

    from gpc_tpu_torch import kernels as KM
    from gpc_tpu_torch.models.gp import GP

    S = importlib.import_module("gpc_tpu_torch.optim.scg")

    X, y, _ = _data(5, n=60)
    kern = KM.Cmpnd(input_dim=3, components=(KM.Rbf(input_dim=3), KM.Bias(input_dim=3),
                                             KM.White(input_dim=3)))
    gp = GP(kern, X, y, device="cpu")
    vag = gp.value_and_grad_fn()
    evals = []

    def f(w):
        val, grad = vag(w)
        evals.append((np.array(w), val, np.array(grad)))
        return val, grad
    step = S._step
    if frozen:
        S._step = lambda fn, st, n, tol: (dict(st, iter=st["iter"] + 1) if st["iter"] == 1
                                          else step(fn, st, n, tol))
    try:
        res = S.scg(f, gp.theta, max_iters=iters)
    finally:
        S._step = step
    return gp.theta, evals, res


def test_the_scg_replay_follows_the_program_step_by_step():
    theta0, evals, res = _program_scg_run()
    assert scg_ref.replay(evals, theta0, 8, result_w=res.x) < 1e-9   # rounding: the program fuses a·b + c


def test_the_scg_replay_catches_a_step_that_returns_its_state_unchanged():
    theta0, evals, res = _program_scg_run(frozen=True)
    assert scg_ref.replay(evals, theta0, 8, result_w=res.x) >= 1.0


def test_the_scg_replay_in_float32_is_the_optimisers_control():
    theta0, evals, res = _program_scg_run()
    gap = scg_ref.replay(evals, theta0, 8, result_w=res.x, dtype=np.float32)
    assert 1e-9 < gap
