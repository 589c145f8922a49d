"""The FTC inference slice of gpc_tpu_torch against gpc_tpu, on the CPU.

Same numpy inputs through both packages: transforms, priors and jitchol;
the panel evidence engine against gpc_tpu's (Pallas interpret mode) at the
bf16 bound 2e-3; the dense FTC log-likelihood and GPServer in float64 at
1e-10; from_jax and model files in both directions.  The slice on the card
is compared with the CPU float64 route in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu import linalg as JL
from gpc_tpu import priors as JP
from gpc_tpu import transforms as JT
from gpc_tpu.io import model_io as JIO
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.ops import panel_engine as JPE
from gpc_tpu.serving import GPServer as JServer
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch import linalg as TL
from gpc_tpu_torch import transforms as TT
from gpc_tpu_torch.interop.from_jax import from_jax, kern_from_desc
from gpc_tpu_torch.io import model_io as TIO
from gpc_tpu_torch.models import gp as TGPM
from gpc_tpu_torch.models.gp import GP as TGP
from gpc_tpu_torch.priors import Prior as TPrior
from gpc_tpu_torch.ops import evidence_mode as TEM
from gpc_tpu_torch.ops import panel_engine as TPE
from gpc_tpu_torch.serving import GPServer as TServer
from gpc_tpu_torch.utils.profiling import COUNTS


def _jax_kern(q, *kinds, priors=()):
    make = {"rbf": lambda: GK.Rbf(input_dim=q).with_priors(priors),
            "bias": lambda: GK.Bias(input_dim=q), "white": lambda: GK.White(input_dim=q),
            "whitefixed": lambda: GK.WhiteFixed(input_dim=q, fixed_variance=0.05)}
    return GK.Cmpnd(input_dim=q, components=tuple(make[k]() for k in kinds))


def _data(N, q, seed, D=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, q))
    y = np.sin(X[:, :1] * np.arange(1, D + 1)) + 0.05 * rng.standard_normal((N, D))
    return X, y, rng


def _pair(N=96, q=2, seed=0, kinds=("rbf", "bias", "white"), priors=(),
          learn_scales=False, D=1):
    """A gpc_tpu GP at non-default parameters and its port via from_jax."""
    X, y, rng = _data(N, q, seed, D)
    kern = _jax_kern(q, *kinds, priors=priors)
    jm = JGP(kern, X, y, centre=True, scale_data=True, learn_scales=learn_scales)
    jm.theta = jnp.asarray(np.asarray(jm.theta) + 0.1 * rng.standard_normal(jm.theta.shape))
    pm = from_jax(kern, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales,
                  learn_scales=learn_scales, device="cpu")
    return jm, pm, rng


@pytest.mark.parametrize("code", [JT.LINEAR, JT.EXP, JT.NEGLOGLOGIT, JT.SIGMOID])
def test_transforms_match(code):
    a = np.linspace(-40.0, 40.0, 41)
    x = np.asarray(JT.atox(code, jnp.asarray(a)))
    np.testing.assert_allclose(TT.atox(code, torch.from_numpy(a)).numpy(), x, rtol=1e-14)
    xs = np.clip(x, 1e-6, 1 - 1e-6) if code == JT.SIGMOID else x
    np.testing.assert_allclose(TT.xtoa(code, torch.tensor(xs)).numpy(),
                               np.asarray(JT.xtoa(code, jnp.asarray(xs))), rtol=1e-12)
    codes = np.array([JT.EXP, code, JT.LINEAR])
    v = np.array([0.3, -1.2, 2.0])
    np.testing.assert_allclose(TT.apply_atox(codes, torch.from_numpy(v)).numpy(),
                               np.asarray(JT.apply_atox(codes, jnp.asarray(v))), rtol=1e-14)


def test_jitchol_escalation_matches():
    rng = np.random.default_rng(1)
    Z = rng.standard_normal((30, 5))
    A = Z @ Z.T - 1e-3 * np.eye(30)   # eigenvalues -1e-3: needs 5e-3 jitter
    L_j, jit_j = JL.jitchol(jnp.asarray(A))
    L_t, jit_t = TL.jitchol(torch.from_numpy(A))
    assert jit_t > 0 and jit_t == pytest.approx(float(jit_j), rel=1e-12)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-8, atol=1e-10)
    L_bad, _ = TL.jitchol(torch.from_numpy(-np.eye(3)), max_tries=2)
    assert torch.isnan(L_bad).all()


def test_blocked_tri_inv_matches():
    rng = np.random.default_rng(2)
    Z = rng.standard_normal((50, 50))
    L = np.linalg.cholesky(Z @ Z.T + 50 * np.eye(50))
    np.testing.assert_allclose(TL.blocked_tri_inv(torch.from_numpy(L), block=16).numpy(),
                               np.asarray(JL.blocked_tri_inv(jnp.asarray(L), block=16)),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("T", [1, 5, 64, 300])
@pytest.mark.parametrize("N", [1, 37, 128 + 17, 3 * 128 + 5])
def test_tri_apply_reads_the_lower_triangle_alone(N, T):
    """linalg.tri_apply at its leaf of 128 rows (one leaf and a
    ragged tail, three leaves and one, none) against the full product, on
    L⁻¹ in either layout (blocked_tri_inv's is column-major) with its strict
    upper triangle NaN: a finite, equal answer never read that triangle."""
    rng = np.random.default_rng(N * 1000 + T)
    Z = rng.standard_normal((N, N))
    L = np.linalg.cholesky(Z @ Z.T + N * np.eye(N))
    Linv = np.linalg.inv(L)
    B = torch.from_numpy(rng.standard_normal((N, T)))
    want = torch.from_numpy(np.tril(Linv)) @ B
    for layout in (Linv, np.asfortranarray(Linv)):
        poisoned = torch.from_numpy(layout.copy(order="K"))
        poisoned[torch.triu(torch.ones(N, N, dtype=torch.bool), 1)] = float("nan")
        got = TL.tri_apply(poisoned, B)
        assert got.shape == (N, T) and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("kinds", [("rbf", "bias", "white"), ("bias", "rbf", "whitefixed"),
                                   ("rbf",), ("rbf", "rbf", "white"), ("bias", "white")])
def test_panel_split_matches(kinds):
    jk = _jax_kern(3, *kinds)
    assert TPE.panel_split(kern_from_desc(jk)) == JPE.panel_split(jk)


def test_panel_engine_matches_jax_interpret():
    """cmpnd(rbf, bias, white) at ragged N = 1000, D = 2: the port's panel
    engine (padding, rank-1 bias split) against gpc_tpu's, 2e-3 relative on
    logdet and on the quad after the Sherman-Morrison step."""
    N, q, D = 1000, 4, 2
    rng = np.random.default_rng(100)
    kern = _jax_kern(q, "rbf", "bias", "white")
    p = np.array([2.0, 1.1, 0.3, 0.15])
    X = rng.standard_normal((N, q)).astype(np.float32)
    m = rng.standard_normal((N, D)).astype(np.float32)
    ld_j, quad_j = JPE.kern_evidence_panel(kern, jnp.asarray(p, jnp.float32),
                                           jnp.asarray(X), jnp.asarray(m))
    ld_t, quad_t = TPE.kern_evidence_panel(kern_from_desc(kern), torch.from_numpy(p),
                                           torch.tensor(X, dtype=torch.float64),
                                           torch.tensor(m, dtype=torch.float64))
    assert abs(float(ld_t) - float(ld_j)) <= 2e-3 * abs(float(ld_j))
    assert abs(float(quad_t) - float(quad_j)) <= 2e-3 * abs(float(quad_j))


def test_panel_engine_noiseless_falls_back_to_dense(monkeypatch):
    """GPC_TPU_EVIDENCE=panel with a noiseless cmpnd(rbf, bias): gpc_tpu's
    warning, then the dense engine's value; the panel engine itself
    refuses the kernel."""
    X, y, _ = _data(60, 2, 3)
    kern = TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2), TK.Bias(input_dim=2)))
    p = torch.tensor([1.0, 1.0, 0.3], dtype=torch.float64)
    Xt, m = torch.from_numpy(X), torch.from_numpy(y)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    with pytest.warns(UserWarning, match="noise"):
        assert TEM.resolve_engine(kern, 60) == "dense"
    with pytest.warns(UserWarning, match="noise"):
        ld, quad = TEM.kern_evidence(kern, p, Xt, m)
    ld_d, quad_d, _ = TL.evidence_terms(kern.gram(p, Xt), m)
    assert float(ld) == float(ld_d) and float(quad) == float(quad_d)
    with pytest.raises(ValueError, match="white/noise ridge"):
        TPE.kern_evidence_panel(kern, p, Xt, m)


def test_panel_engine_outside_family_raises(monkeypatch):
    """Outside the panel family the panel engine raises; the dispatcher
    warns and runs what lazy would, here dense (N = 8 being too small to
    split), as gpc_tpu does."""
    kern = TK.Cmpnd(input_dim=2, components=(TK.Bias(input_dim=2), TK.White(input_dim=2)))
    X = torch.zeros((8, 2), dtype=torch.float64)
    p = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="cmpnd"):
        TPE.kern_evidence_panel(kern, p, X, X[:, :1])
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    with pytest.warns(UserWarning, match="falling back to the lazy engine"):
        ld, quad = TEM.kern_evidence(kern, p, X, X[:, :1])
    ld_d, quad_d, _ = TL.evidence_terms(kern.gram(p, X), X[:, :1])
    np.testing.assert_allclose([float(ld), float(quad)], [float(ld_d), float(quad_d)],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["lazy", "iterative", "bogus"])
def test_evidence_mode_unported_and_invalid(monkeypatch, mode):
    """iterative takes any size (no split requirement, as in gpc_tpu), an
    unknown engine is a ValueError, and lazy on a size that does not split
    warns and falls back to dense."""
    kern = TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2), TK.White(input_dim=2)))
    monkeypatch.setenv("GPC_TPU_EVIDENCE", mode)
    if mode == "lazy":
        with pytest.warns(UserWarning, match="falling back to dense"):
            assert TEM.resolve_engine(kern, 100) == "dense"
        return
    if mode == "iterative":
        assert TEM.resolve_engine(kern, 100) == "iterative"
        return
    with pytest.raises(ValueError):
        TEM.resolve_engine(kern, 100)


@pytest.mark.parametrize("case", [
    dict(),
    dict(kinds=("rbf", "bias", "whitefixed"), learn_scales=True, D=2),
    dict(priors=(JP.gamma(2.0, 1.5, index=1),)),
])
def test_log_likelihood_matches_dense(case):
    jm, pm, _ = _pair(**case)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(), rtol=1e-10)
    theta, X, y, bias, scales = pm._args()
    nlml = TGPM.make_objective(pm.spec, X, y, bias, scales)
    np.testing.assert_allclose(float(nlml(theta)), -jm.log_likelihood(), rtol=1e-10)


def test_panel_log_likelihood_matches_dense_on_cpu(monkeypatch):
    """On the CPU the panel engine runs K3's plain (float64) version, so
    it agrees with the dense route to rounding."""
    _, pm, _ = _pair(N=150)
    dense = pm.log_likelihood()
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    np.testing.assert_allclose(pm.log_likelihood(), dense, rtol=1e-10)


@pytest.mark.parametrize("explicit_inverse,rtol", [(False, 1e-10), (True, 1e-9)])
def test_server_matches_jax_server(explicit_inverse, rtol):
    """At N = 2·128 + 37, past two of tri_apply's leaves with a ragged
    tail; each chunk served with the explicit inverse counts one
    serve.tri_apply."""
    jm, pm, rng = _pair(N=2 * 128 + 37)
    Xt = rng.standard_normal((37, 2))     # 2 chunks of 16 + a ragged tail of 5
    want_mu, want_var = JServer(jm, chunk=16, explicit_inverse=explicit_inverse).predict(Xt)
    srv = TServer(pm, chunk=16, explicit_inverse=explicit_inverse)
    before = COUNTS["serve.tri_apply"]
    mu, var = srv.predict(Xt)
    assert COUNTS["serve.tri_apply"] - before == (3 if explicit_inverse else 0)
    np.testing.assert_allclose(mu, np.asarray(want_mu), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(var, np.asarray(want_var), rtol=rtol, atol=1e-12)
    p_mu, p_var = pm.predict(Xt)
    np.testing.assert_allclose(mu, p_mu, rtol=rtol, atol=1e-12)
    assert [srv._bucket(t) for t in (1, 5, 16, 40)] == [1, 8, 16, 16]
    mu0, var0 = srv.predict(np.zeros((0, 2)))
    assert mu0.shape == (0, 1) and var0.shape == (0, 1)


def test_from_jax_round_trip(tmp_path):
    jm, pm, _ = _pair(kinds=("rbf", "bias", "white"), priors=(JP.gaussian(0.5, index=0),))
    assert pm.spec.kern.display_names() == jm.spec.kern.display_names()
    np.testing.assert_array_equal(pm.theta, np.asarray(jm.theta))
    np.testing.assert_allclose(pm.kern_params(), jm.kern_params(), rtol=1e-15)
    assert pm.spec.kern.priors_global == tuple(
        TPrior(p.kind, p.hyp, p.index) for p in jm.spec.kern.priors_global)
    JIO.write_gp(tmp_path / "j", jm)
    TIO.write_gp(tmp_path / "t", pm)
    assert (tmp_path / "j").read_text() == (tmp_path / "t").read_text()
    with pytest.raises(ValueError, match="theta"):
        from_jax(jm.spec.kern, np.zeros(2), jm.X, jm.y, jm.bias, jm.fixed_scales,
                 device="cpu")


def test_model_files_cross_load(tmp_path):
    jm, pm, rng = _pair(kinds=("rbf", "bias", "whitefixed"), learn_scales=True, D=2)
    Xt = rng.standard_normal((9, 2))
    JIO.write_gp(tmp_path / "from_jax", jm)
    port = TIO.read_gp(tmp_path / "from_jax", X=jm.X, y=jm.y, device="cpu")
    np.testing.assert_allclose(port.log_likelihood(), jm.log_likelihood(), rtol=1e-10)
    np.testing.assert_allclose(port.predict(Xt)[0], np.asarray(jm.predict(Xt)[0]),
                               rtol=1e-10, atol=1e-12)
    TIO.write_gp(tmp_path / "from_port", pm)
    back = JIO.read_gp(str(tmp_path / "from_port"), X=pm.X, y=pm.y)
    np.testing.assert_allclose(back.log_likelihood(), pm.log_likelihood(), rtol=1e-10)
    TIO.write_gp(tmp_path / "again", port)
    assert (tmp_path / "again").read_text() == (tmp_path / "from_jax").read_text()
    with pytest.raises(TIO.DataDimensionError):
        TIO.read_gp(tmp_path / "from_jax", X=np.zeros((3, 5)))


def test_unported_paths_raise(monkeypatch):
    """An unknown approximation or kernel raises.  (The sparse
    approximations, quasinew and the iterative engine, once here, are
    ported: tests/test_torch_sparse.py, tests/test_torch_optim.py,
    tests/test_torch_iterative.py; the last now gives a finite evidence.)"""
    X, y, _ = _data(10, 2, 4)
    kern = TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2),))
    with pytest.raises(ValueError, match="Unknown sparse approximation"):
        TGP(kern, X, y, approx="bogus", device="cpu")
    assert TGP(kern, X, y, approx="dtc", num_active=3, device="cpu").spec.sparse
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "iterative")
    assert np.isfinite(TGP(kern, X, y, device="cpu").log_likelihood())
    with pytest.raises(ValueError, match="Unknown kernel type"):
        TK.make_kern("bogus", 2)
