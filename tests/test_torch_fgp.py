"""The port's fGP API (gpc_tpu_torch/interop/fgp.py) against gpc_tpu's
(gpc_tpu/interop/fgp.py), on the CPU in float64.

For each kernel letter (r, e, w, l, B; w added beside the others, as fGP
adds nothing) at N = 64, q = 2: train, retrain on a second draw
(warm-started) and query with variance give gpc_tpu's objectives, θ and
predictions within 1e-8 relative (predictions: within 1e-8 of their
largest entry where they pass near zero; SCG amplifies the last-bit
differences of the two packages' objectives).  Every error path gives gpc_tpu's
exception type and message; clear drops the state; the entry points run on
the card unless asked for the CPU."""

import importlib

import numpy as np
import pytest
import torch

from gpc_tpu.interop import clear as jclear
from gpc_tpu.interop import fgp as jfgp
from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch.interop import clear, fgp, query, retrain, train

# the packages' interop/__init__ export the function fgp over the module
jax_fgp_mod = importlib.import_module("gpc_tpu.interop.fgp")
port_fgp_mod = importlib.import_module("gpc_tpu_torch.interop.fgp")


@pytest.fixture(autouse=True)
def _fresh_state():
    clear()
    jclear()
    yield
    clear()
    jclear()


def _draw(seed, n=64, q=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, q))
    Y = np.sin(X[:, :1]) * np.cos(X[:, 1:]) + 0.05 * rng.standard_normal((n, 1))
    return X, Y


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * np.max(np.abs(ref)))


@pytest.mark.parametrize("kernels", ["rw", "ew", "w", "lw", "Bw", "rBw"])
def test_train_retrain_query_match_gpc_tpu(kernels):
    X, Y = _draw(0)
    X2, Y2 = _draw(1)
    Xq, _ = _draw(2, n=33)
    obj = train(kernels, X, Y, iters=5, device="cpu")
    jobj = jfgp("train", kernels, X, Y, iters=5)
    np.testing.assert_allclose(obj, jobj, rtol=1e-8)
    mu, var = query(Xq, want_variance=True)
    jmu, jvar = jfgp("query", Xq, want_variance=True)
    _close(mu, jmu)
    _close(var, jvar)
    obj2 = retrain(X2, Y2.ravel(), iters=5)            # a 1-D Y, as fGP allows
    jobj2 = jfgp("retrain", X2, Y2.ravel(), iters=5)
    np.testing.assert_allclose(obj2, jobj2, rtol=1e-8)
    np.testing.assert_allclose(port_fgp_mod._state["model"].theta,
                               np.asarray(jax_fgp_mod._state["model"].theta), rtol=1e-8)
    mu2 = query(Xq)
    _close(mu2, jfgp("query", Xq))
    assert mu2.shape == (33, 1)
    assert port_fgp_mod._state["model"].device.type == "cpu"   # retrain keeps the device


def _message(fn, *args, **kw):
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    return type(exc.value), str(exc.value)


ERRORS = [
    ("query before train", lambda g: g("query", np.zeros((3, 1)))),
    ("retrain before train", lambda g: g("retrain", np.zeros((3, 1)), np.zeros((3, 1)))),
    ("illegal letter", lambda g: g("train", "rz", np.zeros((3, 1)), np.zeros((3, 1)))),
    ("empty X", lambda g: g("train", "r", np.zeros((0, 1)), np.zeros((0, 1)))),
    ("1-D X", lambda g: g("train", "r", np.zeros(3), np.zeros(3))),
    ("Y rows", lambda g: g("train", "r", np.zeros((3, 1)), np.zeros((4, 1)))),
    ("Y columns", lambda g: g("train", "r", np.zeros((3, 1)), np.zeros((3, 2)))),
    ("help", lambda g: g("help")),
    ("empty command", lambda g: g("")),
    ("unknown command", lambda g: g("bogus")),
]


@pytest.mark.parametrize("case", ERRORS, ids=[c[0] for c in ERRORS])
def test_error_paths_match_gpc_tpu(case):
    _, call = case
    port = _message(call, lambda cmd, *a: fgp(cmd, *a, device="cpu") if cmd == "train"
                    else fgp(cmd, *a))
    ref = _message(call, jfgp)
    assert port == ref


@pytest.mark.parametrize("call", ["query", "retrain"])
def test_input_dimension_errors_after_train(call):
    X, Y = _draw(3, n=20)
    train("r", X, Y, iters=2, device="cpu")
    jfgp("train", "r", X, Y, iters=2)
    args = (np.zeros((3, 3)),) if call == "query" else (np.zeros((3, 3)), np.zeros((3, 1)))
    assert _message(fgp, call, *args) == _message(jfgp, call, *args)


def test_clear_drops_the_state():
    X, Y = _draw(4, n=20)
    fgp("train", "rw", X, Y, iters=2, device="cpu")
    assert fgp("query", X).shape == (20, 1)
    fgp("clear")
    with pytest.raises(RuntimeError, match="cannot be queried"):
        fgp("query", X)


def test_train_wants_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = _draw(5, n=10)
    with pytest.raises(NoDeviceError):
        train("rw", X, Y, iters=1)
