"""The port's GP-LVM / GPDM (gpc_tpu_torch.models.gplvm) against
gpc_tpu.models.gplvm, on the CPU in float64.

Each port model is built from gpc_tpu's through interop.from_jax.
gplvm_from_jax, or by the port's constructor on the same numpy inputs.
The objective and its gradient in θ (kernel, dynamics kernel, latents or
back-constraint coefficients, scales) match gpc_tpu's jax.value_and_grad
within 1e-10 (value) and 1e-9 (relative L2) under dense, lazy (a small
GPC_TPU_EVIDENCE_BASE) and iterative (gpc_tpu's own probes injected), for
the plain model, GPDM with breaks (0, 7) learnt and fixed, back
constraints, learned scales, no latent regulariser, priors and dynamic
scaling.  panel is held to the panel tests' bounds
(tests/test_torch_train.py: θ̄ at 8e-2 relative L2) against gpc_tpu's
panel engine (Pallas interpret mode, float32) on spread latents, and the
drift both panel engines show on clustered q = 2 PCA latents is measured.
20 SCG iterations, the initialisations (PCA, back constraints, the
reference's MT19937 "rand"), predict_from_latent and the model files
(byte-identical text, each package reading the other's) complete it.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu import priors as JP
from gpc_tpu.io import model_io as JIO
from gpc_tpu.models import gplvm as JGL
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.interop.from_jax import gplvm_from_jax, kern_from_desc
from gpc_tpu_torch.io import model_io as TIO
from gpc_tpu_torch.models import gplvm as TGL
from gpc_tpu_torch.ops import iterative as TI


def _kern(q, priors=()):
    return GK.Cmpnd(input_dim=q, components=(
        GK.Rbf(input_dim=q).with_priors(priors), GK.Bias(input_dim=q), GK.White(input_dim=q)))


def _y(N=48, D=3, seed=3):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 3 * np.pi, N)
    W = rng.standard_normal((2, D))
    return np.column_stack([np.sin(t), np.cos(t)]) @ W + 0.05 * rng.standard_normal((N, D))


def _jax_model(case, N=48, D=3, q=2, move_kernels=True):
    """A gpc_tpu GPLVM for one of CASES, θ moved off its initial point (the
    latents only, without `move_kernels`)."""
    y = _y(N, D)
    kw = {}
    if case in ("dyn", "dyn_fixed", "dyn_scaled"):
        kw = dict(dyn_kern=_kern(q), dyn_breaks=(0, 7))
        if case == "dyn_fixed":
            kw.update(dyn_kern_learnt=False,
                      dyn_kern_params=np.array([0.8, 0.3, 0.1, 0.02]))
        if case == "dyn_scaled":
            kw.update(dynamic_scaling=True, latent_regularised=False)
    if case == "back":
        bk = GK.Rbf(input_dim=D)
        kw["back_kernel_matrix"] = np.asarray(bk.gram(jnp.asarray([0.5, 1.0]), jnp.asarray(y))) \
            + 1e-3 * np.eye(N)
    if case == "scales":
        kw.update(learn_scales=True, scale_data=True)
    if case == "noreg":
        kw["latent_regularised"] = False
    priors = (JP.gamma(2.0, 1.5, index=1),) if case == "prior" else ()
    jm = JGL.GPLVM(_kern(q, priors), y, latent_dim=q, **kw)
    rng = np.random.default_rng(5)
    step = 0.05 * rng.standard_normal(jm.theta.shape)
    if not move_kernels:
        nk = jm.spec.kern.n_params + (jm.spec.dyn_kern.n_params if case == "dyn" else 0)
        step[:nk] = 0.0
    jm.theta = jnp.asarray(np.asarray(jm.theta) + step)
    return jm


CASES = ["plain", "dyn", "dyn_fixed", "dyn_scaled", "back", "scales", "noreg", "prior"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _compare(jm, pm, vtol=1e-10, gtol=1e-9):
    v, g = jax.value_and_grad(jm._objective)(jm.theta)
    pv, pg = pm.value_and_grad_fn()(pm.theta)
    np.testing.assert_allclose(pv, float(v), rtol=vtol)
    assert _rel(pg, g) < gtol
    return pv, pg


@pytest.mark.parametrize("case", CASES)
def test_objective_and_gradient_match_dense(case, monkeypatch):
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    jm = _jax_model(case)
    pm = gplvm_from_jax(jm, device="cpu")
    assert pm.spec.n_params() == jm.spec.n_params()
    _compare(jm, pm)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-10)


@pytest.mark.parametrize("case", ["plain", "dyn", "back", "scales"])
def test_objective_and_gradient_match_lazy(case, monkeypatch):
    """The left-looking lazy engine at base 16 (N = 48 splits into three
    leaves), the dynamics term dense, as in gpc_tpu."""
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "16")
    jm = _jax_model(case)
    _compare(jm, gplvm_from_jax(jm, device="cpu"))


def _jax_probes(seed, N, T, P, dtype, device):
    k_tr, k_slq = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), N))
    Ztr = np.array(jax.random.rademacher(k_tr, (N, T), dtype=jnp.float64))
    Zs = np.stack([np.asarray(jax.random.rademacher(k, (N,), dtype=jnp.float64))
                   for k in jax.random.split(k_slq, P)], axis=1)
    return (torch.as_tensor(Ztr, dtype=dtype, device=device),
            torch.as_tensor(Zs, dtype=dtype, device=device))


@pytest.mark.parametrize("case", ["plain", "dyn", "back"])
def test_objective_and_gradient_match_iterative(case, monkeypatch):
    """GPC_TPU_EVIDENCE=iterative with gpc_tpu's probes: the latent
    evidence and, under dynamics, the masked engine for dynK."""
    monkeypatch.setattr(TI, "rademacher_probes", _jax_probes)
    for k, v in dict(GPC_TPU_EVIDENCE="iterative", GPC_TPU_ITER_BLOCK="20",
                     GPC_TPU_ITER_PROBES="6", GPC_TPU_ITER_TPROBES="4").items():
        monkeypatch.setenv(k, v)
    jm = _jax_model(case)
    _compare(jm, gplvm_from_jax(jm, device="cpu"))


def _f32(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _jax_panel_vag(jm):
    """gpc_tpu's panel engine takes float32 (as its bench does)."""
    spec = jm.spec
    return jax.value_and_grad(lambda th: -JGL.log_likelihood(
        spec, th, _f32(jm.y), _f32(jm.noise_bias), _f32(jm.fixed_scales),
        dyn_params_fixed=None if jm.dyn_params_fixed is None else _f32(jm.dyn_params_fixed)))(
        _f32(jm.theta))


@pytest.mark.parametrize("case", ["plain", "dyn"])
def test_panel_matches_within_panel_bounds(case, monkeypatch):
    """Spread latents (the panel tests' conditioning domain): the port's
    panel route against gpc_tpu's (f32, interpret mode) and against the
    port's dense route, θ̄ within 8e-2 relative L2."""
    jm = _jax_model(case, N=64, D=4)
    th = np.asarray(jm.theta).copy()
    th[jm.spec.kern.n_params + (jm.spec.dyn_kern.n_params if case == "dyn" else 0):] *= 3.0
    jm.theta = jnp.asarray(th)
    pm = gplvm_from_jax(jm, device="cpu")
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    vd, gd = pm.value_and_grad_fn()(pm.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    vp, gp = pm.value_and_grad_fn()(pm.theta)
    vj, gj = _jax_panel_vag(jm)
    np.testing.assert_allclose(vp, float(vj), rtol=2e-3)
    np.testing.assert_allclose(vp, vd, rtol=2e-3)
    assert _rel(gp, gj) < 8e-2 and _rel(gp, gd) < 8e-2


def test_panel_drift_on_pca_latents(monkeypatch):
    """The finding behind the card's panel GP-LVM run: on clustered q = 2
    PCA latents (tanh(Z·W) data, the card's geometry at N = 256) gpc_tpu's
    panel engine leaves the dense route by more than its 2e-3 bound — its
    bf16 factor meets κ·ε_bf16 ≈ 1 — while the port's CPU panel route
    (float64 factor, bf16 T only in the backward) stays with dense."""
    N, D, q = 256, 4, 2
    rng = np.random.default_rng(0)
    Z, W = rng.standard_normal((N, q)), rng.standard_normal((q, D))
    y = np.tanh(Z @ W) + 0.1 * rng.standard_normal((N, D))
    jm = JGL.GPLVM(_kern(q), y, latent_dim=q)
    pm = gplvm_from_jax(jm, device="cpu")
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    vd, gd = pm.value_and_grad_fn()(pm.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    vp, gp = pm.value_and_grad_fn()(pm.theta)
    vj, _gj = _jax_panel_vag(jm)
    assert abs(float(vj) - vd) / abs(vd) > 2e-3
    assert abs(vp - vd) / abs(vd) < 1e-12 and _rel(gp, gd) < 8e-2


def test_scg_trajectory_matches(monkeypatch):
    """20 SCG iterations from the same θ: θ within 1e-8 relative L2."""
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    jm = _jax_model("dyn", N=32)
    pm = gplvm_from_jax(jm, device="cpu")
    rj = jm.optimise(iters=20)
    rp = pm.optimise(iters=20)
    assert int(rp.iters) == int(rj.iters)
    assert _rel(pm.theta, jm.theta) < 1e-8
    np.testing.assert_allclose(float(rp.obj), float(rj.obj), rtol=1e-9)


@pytest.mark.parametrize("init", ["pca", "rand", "back"])
def test_initialisation_matches(init):
    y = _y(40, 4)
    q = 2
    kw = {}
    if init == "back":
        kw["back_kernel_matrix"] = np.exp(-0.5 * np.sum((y[:, None] - y[None]) ** 2, -1)) \
            + 1e-2 * np.eye(40)
    jm = JGL.GPLVM(_kern(q), y, latent_dim=q, init="rand" if init == "rand" else "pca",
                   seed=11, **kw)
    pm = TGL.GPLVM(kern_from_desc(jm.spec.kern), y, latent_dim=q,
                   init="rand" if init == "rand" else "pca", seed=11, device="cpu",
                   back_kernel_matrix=kw.get("back_kernel_matrix"))
    np.testing.assert_allclose(pm.theta, np.asarray(jm.theta), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pm.latent_X(), jm.latent_X(), rtol=1e-10, atol=1e-12)
    m = y - y.mean(0)
    np.testing.assert_allclose(TGL.pca_init(m, q), JGL.pca_init(m, q), rtol=1e-12, atol=1e-12)


def test_predict_from_latent_matches():
    jm = _jax_model("scales")
    pm = gplvm_from_jax(jm, device="cpu")
    Xt = np.random.default_rng(2).standard_normal((30, 2))
    mu_j, var_j = jm.predict_from_latent(Xt)
    mu_p, var_p = pm.predict_from_latent(Xt)
    np.testing.assert_allclose(mu_p, np.asarray(mu_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var_p, np.asarray(var_j), rtol=1e-10, atol=1e-12)
    num = r"[-+]?\d+\.\d+(?:e[-+]\d+)?"
    assert re.sub(num, "#", pm.display()) == re.sub(num, "#", jm.display())
    np.testing.assert_allclose([float(v) for v in re.findall(num, pm.display())],
                               [float(v) for v in re.findall(num, jm.display())], rtol=1e-14)


@pytest.mark.parametrize("case,labels", [("plain", False), ("plain", True), ("dyn", False)])
def test_model_files_match(tmp_path, case, labels):
    """write_gplvm gives gpc_tpu's bytes for the same model (kernel
    parameters and latents that both packages compute alike: XLA's exp and
    its bK·A product may differ from torch's in the last bit, which
    test_model_file_numbers_match covers); each package reads the other's
    file to the same log-likelihood."""
    jm = _jax_model(case, move_kernels=False)
    pm = gplvm_from_jax(jm, device="cpu")
    lab = np.arange(jm.spec.n_data) % 3 if labels else None
    JIO.write_gplvm(tmp_path / "jax", jm, labels=lab, comment="a model")
    TIO.write_gplvm(tmp_path / "port", pm, labels=lab, comment="a model")
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    back, lab_p = TIO.read_gplvm(tmp_path / "jax", device="cpu")
    jback, _ = JIO.read_gplvm(tmp_path / "port")
    assert (lab_p is None) == (not labels)
    if labels:
        np.testing.assert_array_equal(lab_p, lab)
    np.testing.assert_allclose(back.log_likelihood(), jback.log_likelihood(), rtol=1e-10)
    np.testing.assert_allclose(back.latent_X(), jm.latent_X(), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("case", ["dyn", "back"])
def test_model_file_numbers_match(tmp_path, case):
    """Moved kernel parameters, and back-constrained latents X = bK·A: the
    same text around the numbers, the numbers to the last bits (XLA's exp
    and dot round apart from torch's)."""
    jm = _jax_model(case)
    JIO.write_gplvm(tmp_path / "jax", jm)
    TIO.write_gplvm(tmp_path / "port", gplvm_from_jax(jm, device="cpu"))
    num = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")
    a, b = (tmp_path / "port").read_text(), (tmp_path / "jax").read_text()
    assert num.sub("#", a) == num.sub("#", b)
    np.testing.assert_allclose([float(v) for v in num.findall(a)],
                               [float(v) for v in num.findall(b)], rtol=1e-14)


def test_gplvm_needs_a_card_by_default():
    import gpc_tpu_torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(gpc_tpu_torch.NoDeviceError):
        TGL.GPLVM(TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2),)), _y(10, 2))


def test_evidence_engine_is_read_at_call_time(monkeypatch):
    """The engine is chosen per call of the objective, as in gpc_tpu, and
    every engine gives one value to rounding here (iterative aside)."""
    jm = _jax_model("plain", N=64, D=4)
    pm = gplvm_from_jax(jm, device="cpu")
    vals = {}
    for eng in ("dense", "lazy", "panel"):
        monkeypatch.setenv("GPC_TPU_EVIDENCE", eng)
        monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "16")
        vals[eng] = pm.log_likelihood()
    np.testing.assert_allclose([vals["lazy"], vals["panel"]], [vals["dense"]] * 2, rtol=1e-12)
    monkeypatch.delenv("GPC_TPU_EVIDENCE")
    assert os.environ.get("GPC_TPU_EVIDENCE") is None
    assert pm.log_likelihood() == vals["dense"]
