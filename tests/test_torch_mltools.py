"""The port's mapping models (gpc_tpu_torch.models.mltools) against
gpc_tpu.models.mltools, on the CPU in float64, at the same seeds: the
initial θ (np.random.RandomState) exactly, the log-likelihood, `out` and
point_log_likelihood within 1e-12, θ after 30 SCG iterations within 1e-8
relative L2; the θ layouts round-trip; the card is the default device."""

import numpy as np
import pytest
import torch

from gpc_tpu.models import mltools as JM
from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch.models import mltools as TM


def _data(N, q, D, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, q))
    y = np.sin(X @ rng.standard_normal((q, D))) + 0.05 * rng.standard_normal((N, D))
    return X, y


def _pair(kind, seed=3):
    X, y = _data(40, 3, 2, seed)
    if kind == "linear":
        return JM.LinearMapping(X, y, seed=seed), TM.LinearMapping(X, y, seed=seed, device="cpu"), X, y
    return (JM.MlpMapping(X, y, hidden_dim=5, seed=seed),
            TM.MlpMapping(X, y, hidden_dim=5, seed=seed, device="cpu"), X, y)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_initial_state_and_likelihood_match(kind):
    jm, pm, X, y = _pair(kind)
    np.testing.assert_array_equal(pm.theta, np.asarray(jm.theta))
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-12)
    Xt = np.random.default_rng(8).standard_normal((7, 3))
    np.testing.assert_allclose(pm.out(Xt), np.asarray(jm.out(Xt)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pm.point_log_likelihood(y, X),
                               np.asarray(jm.point_log_likelihood(y, X)), rtol=1e-12)
    # the reference's N·log 2π (not N·D): the points sum to the total
    np.testing.assert_allclose(pm.point_log_likelihood(y, X).sum(), pm.log_likelihood(),
                               rtol=1e-9)


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_scg_trajectory_matches(kind):
    jm, pm, _, _ = _pair(kind, seed=4)
    rj, rp = jm.optimise(iters=30), pm.optimise(iters=30)
    assert int(rp.iters) == int(rj.iters)
    assert _rel(pm.theta, jm.theta) < 1e-8
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-9)


def test_layouts_round_trip():
    _jm, pm, _, _ = _pair("mlp")
    parts = pm.unpack(torch.as_tensor(pm.theta))
    assert [tuple(t.shape) for t in parts] == [(3, 5), (1, 5), (5, 2), (1, 2)]
    np.testing.assert_array_equal(pm.pack(*(t.numpy() for t in parts)), pm.theta)
    _jl, pl, _, _ = _pair("linear")
    W, b = pl.unpack(torch.as_tensor(pl.theta))
    np.testing.assert_array_equal(pl.pack(W.numpy(), b.numpy()), pl.theta)


def test_card_is_the_default():
    X, y = _data(5, 2, 1, 0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoDeviceError):
        TM.LinearMapping(X, y)
