"""The sparse GP of gpc_tpu_torch (DTC / DTCVAR / FITC / PITC) against
gpc_tpu, on the CPU in float64.

The same numpy inputs from a seed go through both packages.  Tolerances:
the log-likelihood within 1e-12 relative and its gradient in θ (X_u, the
kernel, the scales, β) within 1e-9 of the gradient's largest entry, for the
cmpnd(rbf|mlp, bias, white) models with learned and with fixed inducing
inputs; the posterior mean and variance within 1e-12; PITC with a ragged
last block likewise, and PITC at block size 1 equals FITC up to FITC's
D·N·½log 2π (1e-8, as gpc_tpu's tests/test_gp_pitc.py:34).  The inducing
inputs and the θ layout are equal; the model files of the two packages
carry the same text with numbers within 1e-15 (the kernel's parameters pass
through exp, whose last bit differs between XLA and libm), read back in the
other package with the same log-likelihood (1e-12), and a file read by the
port writes out again within 1e-15.  Neither package's file holds PITC's
block size: a PITC file reads back with blocks of num_active.  The batched
Gram of PITC's blocks equals one 2-D Gram per block within 1e-14 (batched
and 2-D matmuls round differently on the CPU; on the card the kernel's
batches are bit-equal, tests/test_torch_cuda.py), and on the card's launch
path it is one launch with the batch count (CPU stand-ins, as
tests/test_torch_gram.py).
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu import ndlutil
from gpc_tpu.io import model_io as JIO
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.serving import GPServer as JServer
from gpc_tpu.utils.refrng import RefRng as JRefRng
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.interop.from_jax import from_jax
from gpc_tpu_torch.io import model_io as TIO
from gpc_tpu_torch.models.gp import GP as TGP
from gpc_tpu_torch.ops import gram as TG
from gpc_tpu_torch.serving import GPServer as TServer
from gpc_tpu_torch.utils.refrng import RefRng as TRefRng

APPROX = ("dtc", "dtcvar", "fitc", "pitc")


def _kerns(lead, q):
    jk = GK.Cmpnd(input_dim=q, components=(
        {"rbf": GK.Rbf, "mlp": GK.Mlp}[lead](input_dim=q), GK.Bias(input_dim=q),
        GK.White(input_dim=q)))
    tk = TK.Cmpnd(input_dim=q, components=(
        {"rbf": TK.Rbf, "mlp": TK.Mlp}[lead](input_dim=q), TK.Bias(input_dim=q),
        TK.White(input_dim=q)))
    return jk, tk


def _data(N=37, q=2, D=1, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, q))
    y = np.sin(X[:, :1] * np.arange(1, D + 1)) + 0.1 * rng.standard_normal((N, D))
    return X, y, rng


_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _same_file(a, b):
    """Equal text around the numbers, numbers within 1e-15 relative."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(a)],
                               [float(v) for v in _NUM.findall(b)], rtol=1e-15)


def _pair(approx, lead="rbf", fixed=False, pitc_block=5, learn_scales=False, D=1,
          N=37, M=7, seed=0):
    """A gpc_tpu sparse GP moved off its start, and the port's on the same
    data, seed and θ."""
    X, y, rng = _data(N=N, D=D, seed=seed)
    jk, tk = _kerns(lead, 2)
    kw = dict(approx=approx, num_active=M, seed=3, inducing_fixed=fixed,
              pitc_block=pitc_block if approx == "pitc" else 0, beta=2.0,
              learn_scales=learn_scales, scale_data=learn_scales)
    jm = JGP(jk, X, y, **kw)
    pm = TGP(tk, X, y, device="cpu", **kw)
    assert np.array_equal(np.asarray(jm.theta), pm.theta)
    theta = np.asarray(jm.theta) + 0.05 * rng.standard_normal(pm.theta.shape)
    jm.theta = jnp.asarray(theta)
    pm.theta = theta.copy()
    return jm, pm, rng


@pytest.mark.parametrize("fixed", [False, True], ids=["learned", "fixed"])
@pytest.mark.parametrize("lead", ["rbf", "mlp"])
@pytest.mark.parametrize("approx", APPROX)
def test_log_likelihood_and_gradient_match_jax(approx, lead, fixed):
    jm, pm, _ = _pair(approx, lead, fixed)
    lj, lt = jm.log_likelihood(), pm.log_likelihood()
    assert abs(lt - lj) <= 1e-12 * abs(lj)
    fj, gj = jax.value_and_grad(jm._objective)(jm.theta)
    ft, gt = pm.value_and_grad_fn()(pm.theta)
    gj = np.asarray(gj)
    assert abs(ft - float(fj)) <= 1e-12 * abs(float(fj))
    assert gt.shape == gj.shape == (pm.spec.n_params(),)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-9 * np.abs(gj).max())
    # the gradient reaches X_u (unless fixed) and β
    n_xu = 0 if fixed else 7 * 2
    assert np.abs(gt[:n_xu]).max(initial=1.0) > 0 and gt[-1] != 0


@pytest.mark.parametrize("approx", APPROX)
def test_learned_scales_two_outputs_match_jax(approx):
    jm, pm, _ = _pair(approx, learn_scales=True, D=2)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-12)
    gj = np.asarray(jax.grad(jm._objective)(jm.theta))
    gt = pm.value_and_grad_fn()(pm.theta)[1]
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-9 * np.abs(gj).max())


@pytest.mark.parametrize("approx", APPROX)
def test_posterior_matches_jax(approx):
    jm, pm, rng = _pair(approx, fixed=approx == "dtcvar")
    Xt = rng.standard_normal((11, 2))
    mu_j, var_j = jm.predict(Xt)
    mu_t, var_t = pm.predict(Xt)
    np.testing.assert_allclose(mu_t, np.asarray(mu_j), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(var_t, np.asarray(var_j), rtol=1e-12, atol=1e-13)
    assert (var_t >= 0).all()


@pytest.mark.parametrize("block", [5, 8, 36, 37, 50])
def test_pitc_block_sizes_match_jax(block):
    """Ragged last blocks (37 = 7·5 + 2 = 4·8 + 5 = 36 + 1), one block, and
    a block wider than N."""
    jm, pm, _ = _pair("pitc", pitc_block=block)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-12)
    gj = np.asarray(jax.grad(jm._objective)(jm.theta))
    gt = pm.value_and_grad_fn()(pm.theta)[1]
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-9 * np.abs(gj).max())


def test_pitc_block_one_equals_fitc():
    """gpc_tpu's tests/test_gp_pitc.py:34 in the port: PITC at block size 1
    is FITC but for FITC's extra D·N·½log 2π."""
    X, y, _ = _data(N=40, D=2)
    _, tk = _kerns("rbf", 2)
    fitc = TGP(tk, X, y, approx="fitc", num_active=7, seed=3, device="cpu")
    pitc = TGP(tk, X, y, approx="pitc", num_active=7, seed=3, pitc_block=1, device="cpu")
    np.testing.assert_array_equal(fitc.theta, pitc.theta)
    quirk = 2 * 40 * ndlutil.HALFLOGTWOPI
    assert abs(pitc.log_likelihood() - (fitc.log_likelihood() + quirk)) < 1e-8
    for a, b in zip(fitc.predict(X[:11]), pitc.predict(X[:11])):
        np.testing.assert_allclose(b, a, atol=1e-9)


@pytest.mark.parametrize("N,M,seed", [(37, 7, 0), (500, 64, 3), (16384, 1024, 42)])
def test_inducing_selection_matches_refrng(N, M, seed):
    got = TRefRng(seed).randperm_trunc(N, M)
    assert list(got) == list(JRefRng(seed).randperm_trunc(N, M))
    X, y, _ = _data(N=N)
    if N <= 500:
        _, tk = _kerns("rbf", 2)
        jk, _ = _kerns("rbf", 2)
        pm = TGP(tk, X, y, approx="dtc", num_active=M, seed=seed, device="cpu")
        jm = JGP(jk, X, y, approx="dtc", num_active=M, seed=seed)
        np.testing.assert_array_equal(pm.inducing(), np.asarray(jm.inducing()))
        np.testing.assert_array_equal(pm.inducing(), X[np.sort(got)])


def test_theta_layout_is_column_major():
    """θ starts with X_u column by column and ends with log β."""
    X, y, _ = _data()
    _, tk = _kerns("rbf", 2)
    pm = TGP(tk, X, y, approx="fitc", num_active=7, seed=3, beta=4.0, device="cpu")
    Xu = pm.inducing()
    np.testing.assert_array_equal(pm.theta[:14], np.concatenate([Xu[:, 0], Xu[:, 1]]))
    assert pm.theta[-1] == np.log(4.0) and pm.beta() == pytest.approx(4.0, rel=1e-15)
    X_u, kp, scales, beta = pm.spec.unpack(torch.as_tensor(pm.theta))
    np.testing.assert_array_equal(X_u.numpy(), Xu)
    assert X_u.is_contiguous() and scales is None
    assert "  beta: " in pm.display()


@pytest.mark.parametrize("approx", APPROX)
def test_model_files_cross_load(tmp_path, approx):
    jm, pm, _ = _pair(approx, fixed=approx == "fitc", learn_scales=approx == "dtc",
                      pitc_block=0)
    JIO.write_gp(str(tmp_path / "j"), jm)
    TIO.write_gp(tmp_path / "t", pm)
    _same_file((tmp_path / "t").read_text(), (tmp_path / "j").read_text())
    port = TIO.read_gp(tmp_path / "j", X=jm.X, y=jm.y, device="cpu")
    assert port.spec == pm.spec
    np.testing.assert_allclose(port.log_likelihood(), jm.log_likelihood(), rtol=1e-12)
    back = JIO.read_gp(str(tmp_path / "t"), X=pm.X, y=pm.y)
    np.testing.assert_allclose(back.log_likelihood(), pm.log_likelihood(), rtol=1e-12)
    TIO.write_gp(tmp_path / "again", port)
    _same_file((tmp_path / "again").read_text(), (tmp_path / "j").read_text())


@pytest.mark.parametrize("approx", ["dtc", "pitc"])
def test_from_jax_sparse(approx):
    jm, _, rng = _pair(approx, fixed=approx == "pitc")
    spec = jm.spec
    pm = from_jax(spec.kern, np.asarray(jm.theta), jm.X, jm.y, jm.bias, jm.fixed_scales,
                  approx=spec.approx, num_active=spec.num_active, pitc_block=spec.pitc_block,
                  inducing_fixed=spec.inducing_fixed, X_u_fixed=jm.X_u_fixed, device="cpu")
    assert pm.spec.approx == approx and pm.spec.num_active == 7
    assert pm.spec.pitc_block == jm.spec.pitc_block
    assert pm.spec.inducing_fixed == jm.spec.inducing_fixed
    np.testing.assert_array_equal(pm.theta, np.asarray(jm.theta))
    np.testing.assert_array_equal(pm.inducing(), np.asarray(jm.inducing()))
    assert pm.beta() == jm.beta()
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-12)
    Xt = rng.standard_normal((4, 2))
    np.testing.assert_allclose(pm.predict(Xt)[0], np.asarray(jm.predict(Xt)[0]), rtol=1e-12)


@pytest.mark.parametrize("approx", APPROX)
def test_server_matches_jax_server(approx):
    jm, pm, rng = _pair(approx)
    Xt = rng.standard_normal((23, 2))
    srv = TServer(pm, chunk=8)
    assert not srv.explicit_inverse and set(srv.state) >= {"X_u", "L_uu", "L_m", "u"}
    mu_t, var_t = srv.predict(Xt)
    mu_j, var_j = JServer(jm, chunk=8).predict(Xt)
    np.testing.assert_allclose(mu_t, np.asarray(mu_j), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(var_t, np.asarray(var_j), rtol=1e-12, atol=1e-13)
    mu_p, var_p = pm.predict(Xt)
    np.testing.assert_allclose(mu_t, mu_p, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(var_t, var_p, rtol=1e-12, atol=1e-13)
    assert not TServer(pm, explicit_inverse=True).explicit_inverse


@pytest.mark.parametrize("lead", ["rbf", "mlp"])
def test_batched_gram_equals_blockwise(lead):
    """kern.gram on (P, B, q) is P 2-D Grams and matches
    gpc_tpu's vmapped Gram; its gradient reaches every block."""
    jk, tk = _kerns(lead, 2)
    rng = np.random.default_rng(4)
    Xb = rng.standard_normal((3, 6, 2))
    p = torch.tensor(tk.default_params() * 0.7, requires_grad=True)
    Xt = torch.tensor(Xb, requires_grad=True)
    K = tk.gram(p, Xt)
    assert K.shape == (3, 6, 6)
    for b in range(3):
        torch.testing.assert_close(K[b], tk.gram(p, Xt[b]), rtol=1e-14, atol=1e-15)
    want = jax.vmap(lambda xb: jk.gram(jnp.asarray(p.detach().numpy()), xb))(jnp.asarray(Xb))
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(want), rtol=1e-13, atol=1e-15)
    K.sum().backward()
    assert torch.isfinite(Xt.grad).all() and (Xt.grad.abs().sum(dim=(1, 2)) > 0).all()


@pytest.mark.parametrize("inner", [False, True], ids=["dist_gram", "inner_gram"])
def test_batched_launch_path(monkeypatch, inner):
    """On the card a (P, n, q) Gram is one launch of the batched entry point,
    counted apart from the 2-D one, with the batch count first."""
    rng = np.random.default_rng(5)
    X1 = torch.from_numpy(rng.standard_normal((4, 9, 3)).astype(np.float32))
    X2 = torch.from_numpy(rng.standard_normal((4, 5, 3)).astype(np.float32))
    p = torch.tensor([0.5, 1.5, 2.0])
    launched = []
    monkeypatch.setattr(TG.cuda_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(TG.cuda_lib, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(TG.cuda_lib, "stream_of", lambda t: 0)
    out = (TG.inner_gram_kernel("mlp", p, X1, X2) if inner
           else TG.dist_gram_kernel("rbf", p, X1, X2))
    (args,) = launched
    name = "inner_gram" if inner else "dist_gram"
    assert args[:2] == (f"{name}_batched", f"gpc_{name}_batched")
    assert args[2:8] == (4, X1.data_ptr(), X2.data_ptr(), 9, 5, 3)
    assert args[-2] == out.data_ptr() and out.shape == (4, 9, 5)
    with pytest.raises(ValueError, match="shapes"):
        TG.dist_gram_kernel("rbf", p, X1, X2[:3])


def test_sparse_rejects_unknown_approximation():
    X, y, _ = _data()
    _, tk = _kerns("rbf", 2)
    with pytest.raises(ValueError, match="Unknown sparse approximation"):
        TGP(tk, X, y, approx="bogus", device="cpu")
