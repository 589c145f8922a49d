"""The FTC training slice of gpc_tpu_torch against gpc_tpu, on the CPU.

Same numpy inputs through both packages, float64: the objective and its
gradient against `jax.value_and_grad` of gpc_tpu's `make_objective` (1e-10
relative); the jitchol gradient, including the jitter rescue and a factor
that fails every try (NaN value, zero gradient); the panel engine's
backward against gpc_tpu's custom VJP (Pallas interpret mode) and against
the dense gradient, at the bf16-factor bounds of
tests/test_panel_engine.py:97-106; GP.optimise against gpc_tpu's.  The
training path on the card is compared with this CPU route in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu import linalg as JL
from gpc_tpu import priors as JP
from gpc_tpu.models import gp as JGPM
from gpc_tpu.ops import panel_engine as JPE
from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch import linalg as TL
from gpc_tpu_torch.interop.from_jax import from_jax, kern_from_desc
from gpc_tpu_torch.io import model_io as TIO
from gpc_tpu_torch.models.gp import GP as TGP
from gpc_tpu_torch.ops import panel_engine as TPE
from gpc_tpu_torch.utils import profiling as TPROF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_kern(q, *kinds, priors=()):
    make = {"rbf": lambda: GK.Rbf(input_dim=q).with_priors(priors),
            "bias": lambda: GK.Bias(input_dim=q), "white": lambda: GK.White(input_dim=q),
            "whitefixed": lambda: GK.WhiteFixed(input_dim=q, fixed_variance=0.05)}
    return GK.Cmpnd(input_dim=q, components=tuple(make[k]() for k in kinds))


def _pair(N=96, q=2, seed=0, kinds=("rbf", "bias", "white"), priors=(),
          learn_scales=False, D=1):
    """A gpc_tpu GP at non-default parameters and its port via from_jax."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, q))
    y = np.sin(X[:, :1] * np.arange(1, D + 1)) + 0.05 * rng.standard_normal((N, D))
    kern = _jax_kern(q, *kinds, priors=priors)
    jm = JGPM.GP(kern, X, y, centre=True, scale_data=True, learn_scales=learn_scales)
    jm.theta = jnp.asarray(np.asarray(jm.theta) + 0.1 * rng.standard_normal(jm.theta.shape))
    pm = from_jax(kern, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales,
                  learn_scales=learn_scales, device="cpu")
    return jm, pm


CASES = [dict(),
         dict(kinds=("rbf", "bias", "whitefixed"), learn_scales=True, D=2),
         dict(priors=(JP.gamma(2.0, 1.5, index=1),))]


@pytest.mark.parametrize("case", CASES)
def test_value_and_grad_matches_jax(case):
    jm, pm = _pair(**case)
    obj = JGPM.make_objective(jm.spec, jm.X, jm.y, jm.bias, jm.fixed_scales)
    f_j, g_j = jax.value_and_grad(obj)(jm.theta)
    f_t, g_t = pm.value_and_grad_fn()(pm.theta)
    np.testing.assert_allclose(f_t, float(f_j), rtol=1e-10)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-10, atol=1e-12)
    assert g_t.dtype == np.float64 and g_t.shape == pm.theta.shape


def _jitchol_input(case):
    rng = np.random.default_rng(1)
    Z = rng.standard_normal((30, 5))
    if case == "pd":
        return Z @ Z.T + np.eye(30), 10
    if case == "jitter":
        return Z @ Z.T - 1e-3 * np.eye(30), 10   # needs 5e-3 jitter
    return -np.eye(30) - Z @ Z.T, 2              # fails every try


@pytest.mark.parametrize("case", ["pd", "jitter", "fails"])
def test_jitchol_gradient_matches_jax(case):
    A, tries = _jitchol_input(case)
    W = np.random.default_rng(2).standard_normal(A.shape)

    def f_jax(A):
        L, _ = JL.jitchol(A, max_tries=tries)
        return jnp.sum(jnp.tril(W) * L) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

    v_j, g_j = jax.value_and_grad(f_jax)(jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    L, jitter = TL.jitchol(At, max_tries=tries)
    v_t = torch.sum(torch.tril(torch.from_numpy(W)) * L) + TL.chol_logdet(L)
    (g_t,) = torch.autograd.grad(v_t, At)
    assert isinstance(jitter, float)
    if case == "fails":
        assert np.isnan(float(v_t.detach())) and np.isnan(float(v_j))
        assert torch.equal(g_t, torch.zeros_like(g_t))
        np.testing.assert_array_equal(np.asarray(g_j), 0.0)
        return
    assert (jitter > 0) == (case == "jitter")
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-8, atol=1e-10)


def _evidence_input(case):
    """A for evidence_terms' ten tries: PD, PD only with jitter, or a
    zero-diagonal indefinite matrix whose negative eigenvalues (≈ −15) lie
    beyond the largest jitter, 1e9·1e-6·mean|diag| = 1e-3."""
    if case != "fails":
        return _jitchol_input(case)[0]
    W = np.random.default_rng(5).standard_normal((30, 30))
    W = W + W.T
    return W - np.diag(np.diag(W)) + 1e-6 * np.eye(30)


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("case", ["pd", "jitter", "fails"])
def test_evidence_terms_gradient_matches_generic_path_and_jax(case, D):
    """evidence_terms' closed-form backward (one explicit A⁻¹) against the
    generic chain — jitchol, chol_logdet and quad_form through
    _CholNanSafe's VJP — and jax.grad of gpc_tpu's evidence_terms, on
    3·logdet + 0.5·quad; a factor that fails every try gives a NaN value,
    an exactly zero Ā and a NaN m̄, as the generic chain does."""
    A = _evidence_input(case)
    m = np.random.default_rng(6).standard_normal((30, D))

    def f_jax(A, m):
        ld, quad, _ = JL.evidence_terms(A, m)
        return 3.0 * ld + 0.5 * quad

    v_j, (gA_j, gm_j) = jax.value_and_grad(f_jax, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(m))

    def port(terms):
        At, mt = torch.tensor(A, requires_grad=True), torch.tensor(m, requires_grad=True)
        ld, quad = terms(At, mt)
        f = 3.0 * ld + 0.5 * quad
        return (float(f.detach()), *torch.autograd.grad(f, (At, mt)))

    def generic(At, mt):
        L, _ = TL.jitchol(At)
        return TL.chol_logdet(L), TL.quad_form(L, mt)

    before = TPROF.counts().get("evidence.inverse_vjp", 0)
    v_t, gA_t, gm_t = port(lambda At, mt: TL.evidence_terms(At, mt)[:2])
    formed = TPROF.counts().get("evidence.inverse_vjp", 0) - before
    v_g, gA_g, gm_g = port(generic)
    assert formed == (case != "fails")
    assert torch.equal(gA_t, gA_t.T)
    if case == "fails":
        assert np.isnan(v_t) and np.isnan(v_g) and np.isnan(float(v_j))
        assert torch.equal(gA_t, torch.zeros_like(gA_t)) and torch.equal(gA_g, gA_t)
        np.testing.assert_array_equal(np.asarray(gA_j), 0.0)
        assert torch.isnan(gm_t).all() and torch.isnan(gm_g).all()
        return
    for got, want in ((v_t, v_g), (v_t, float(v_j))):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # the routes round differently; at jitter 5e-3 (κ ≈ 1e4) Ā reaches 6e5,
    # so the floor is relative to its largest entry
    for want_A, want_m in ((gA_g.numpy(), gm_g.numpy()), (np.asarray(gA_j), np.asarray(gm_j))):
        np.testing.assert_allclose(gA_t.numpy(), want_A, rtol=1e-8,
                                   atol=1e-10 * np.abs(want_A).max())
        np.testing.assert_allclose(gm_t.numpy(), want_m, rtol=1e-8,
                                   atol=1e-10 * np.abs(want_m).max())


@pytest.mark.parametrize("n, block", [(1, 4), (16, 16), (37, 8), (50, 16), (64, 16)])
def test_tri_gram_lower_matches_the_dense_product(n, block):
    """tri_gram_lower(T) = TᵀT for lower-triangular T, one block row at a
    time — whole, ragged (37 = 4·8 + 5, 50 = 3·16 + 2) and single blocks —
    exactly symmetric, float64 to rounding."""
    T = torch.tril(torch.tensor(np.random.default_rng(n).standard_normal((n, n))))
    G = TL.tri_gram_lower(T, block=block)
    np.testing.assert_allclose(G.numpy(), (T.T @ T).numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(G, G.T)


@pytest.fixture(scope="module")
def panel_grads():
    """(θ̄, X̄, m̄) of logdet + quad at N = 700 (padded) through the port's
    panel engine, gpc_tpu's panel engine (interpret mode, float32) and the
    port's dense route (float64)."""
    N, q, D = 700, 3, 1
    rng = np.random.default_rng(7)
    kern = _jax_kern(q, "rbf", "bias", "white")
    p0 = np.array([2.0, 1.2, 0.25, 0.2])
    X0, m0 = rng.standard_normal((N, q)), rng.standard_normal((N, D))

    def obj_jax(p, X, m):
        ld, quad = JPE.kern_evidence_panel(kern, p, X, m)
        return ld + quad

    g_jax = jax.grad(obj_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (p0, X0, m0)))
    tk = kern_from_desc(kern)

    def port(engine):
        p, X, m = (torch.tensor(a, requires_grad=True) for a in (p0, X0, m0))
        if engine == "panel":
            ld, quad = TPE.kern_evidence_panel(tk, p, X, m)
        else:
            ld, quad, _ = TL.evidence_terms(tk.gram(p, X), m)
        return [g.numpy() for g in torch.autograd.grad(ld + quad, (p, X, m))]

    return dict(panel=port("panel"), jax=[np.asarray(g, np.float64) for g in g_jax],
                dense=port("dense"))


@pytest.mark.parametrize("ref", ["jax", "dense"])
def test_panel_gradients_match(panel_grads, ref):
    """θ̄ elementwise at 2e-2; X̄ and m̄ in relative L2 at 8e-2 — the bounds
    gpc_tpu holds its own panel VJP to against the dense route."""
    got, want = panel_grads["panel"], panel_grads[ref]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)
    for a, b in zip(got[1:], want[1:]):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 8e-2
    assert all(np.isfinite(g).all() for g in got)


def test_panel_forward_mode_follows_grad(monkeypatch):
    """K3 runs mode "full" when nothing needs a gradient and "full+diag"
    (whose T carries L_jj⁻¹ for the backward) when θ does."""
    modes = []
    real = TPE.panel_state_rbf

    def spy(*args, mode="full", **kw):
        modes.append(mode)
        return real(*args, mode=mode, **kw)

    monkeypatch.setattr(TPE, "panel_state_rbf", spy)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    _, pm = _pair(N=150)
    ll = pm.log_likelihood()
    f, g = pm.value_and_grad_fn()(pm.theta)
    assert modes == ["full", "full+diag"]
    np.testing.assert_allclose(f, -ll, rtol=1e-12)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "dense")
    f_d, g_d = pm.value_and_grad_fn()(pm.theta)
    np.testing.assert_allclose(g, g_d, rtol=2e-2, atol=2e-2 * np.abs(g_d).max())


@pytest.mark.parametrize("learn_scales", [False, True])
def test_optimise_matches_jax(learn_scales, capsys):
    jm, pm = _pair(learn_scales=learn_scales, D=2 if learn_scales else 1)
    r_j = jm.optimise(iters=15)
    r_t = pm.optimise(iters=15, verbose=3)           # checkgrad runs first
    assert "Largest difference" in capsys.readouterr().out
    assert r_t.iters == int(r_j.iters) == 15
    assert pm.theta.dtype == np.float64
    np.testing.assert_allclose(pm.theta, np.asarray(jm.theta), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(r_t.obj, float(r_j.obj), rtol=1e-8)
    np.testing.assert_allclose(pm.log_likelihood(), -r_t.obj, rtol=1e-12)


@pytest.mark.parametrize("entry", ["GP", "read_gp", "from_jax", "cuda"])
def test_no_card_and_no_device_raises(entry, monkeypatch, tmp_path):
    """Entry points run on the card unless asked for the CPU: with no card
    they raise and say how to ask, rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jm, pm = _pair(N=20)
    TIO.write_gp(tmp_path / "m", pm)
    make = {"GP": lambda: TGP(pm.spec.kern, pm.X, pm.y),
            "read_gp": lambda: TIO.read_gp(tmp_path / "m"),
            "from_jax": lambda: from_jax(jm.spec.kern, np.asarray(jm.theta), jm.X,
                                         jm.y, jm.bias, jm.fixed_scales),
            "cuda": lambda: TGP(pm.spec.kern, pm.X, pm.y, device="cuda")}
    with pytest.raises(NoDeviceError, match='device="cpu"'):
        make[entry]()
    assert TGP(pm.spec.kern, pm.X, pm.y, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_gpc_tpu():
    """Every module of the package, and chip_smoke.py, imports with jax and
    gpc_tpu blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'gpc_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gpc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(gpc_tpu_torch.__path__, 'gpc_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'gpc_tpu')]\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
