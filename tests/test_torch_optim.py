"""CG, GD (momentum and pull-back) and L-BFGS (native and Python) of
gpc_tpu_torch against gpc_tpu, on the CPU.

Both packages get the same float64 numpy objective (gpc_tpu's momentum GD,
a jitted `lax.while_loop`, reaches it through `jax.pure_callback`), so the
runs differ only in the optimisers' own arithmetic.  CG, GD with pull-back
and both L-BFGS engines are host loops in both packages: their results are
equal bit for bit.  Momentum GD runs in XLA in gpc_tpu and on the host
here, and XLA rounds its update in its own order: the iterates agree within
1e-12 relative (1e-15 absolute, for entries crossing zero) after 400
iterations.  On the GP objective through `GP.optimise` (the port's
FTC model on the CPU, gpc_tpu's own), each optimiser's θ agrees within
1e-8 after a few iterations.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu import optim as JO
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch import optim as TO
from gpc_tpu_torch.models.gp import GP as TGP

# the packages' optim/__init__ export the function lbfgs under the module's name
JL = importlib.import_module("gpc_tpu.optim.lbfgs")
TL = importlib.import_module("gpc_tpu_torch.optim.lbfgs")


def _rosenbrock(n=6):
    """A narrow curved valley: many line-search steps, some rejected."""
    def vag(w):
        w = np.asarray(w, dtype=np.float64)
        a, b = w[:-1], w[1:]
        f = np.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2)
        g = np.zeros_like(w)
        g[:-1] = -400.0 * a * (b - a * a) - 2.0 * (1.0 - a)
        g[1:] += 200.0 * (b - a * a)
        return f, g
    return vag, np.linspace(-1.2, 0.8, n)


def _nan_beyond(vag, bound):
    """vag, but NaN where any |w_i| exceeds `bound` (the optimisers' NaN
    handling: CG pulls back, L-BFGS retreats)."""
    def f(w):
        v, g = vag(w)
        if np.abs(np.asarray(w)).max() > bound:
            return np.nan, np.full_like(g, np.nan)
        return v, g
    return f


def _jax_vag(np_vag):
    """np_vag behind a pure_callback, traceable inside gpc_tpu's jit."""
    def vag(w):
        shapes = (jax.ShapeDtypeStruct((), jnp.float64),
                  jax.ShapeDtypeStruct(w.shape, jnp.float64))

        def host(x):
            v, g = np_vag(np.asarray(x))
            return np.float64(v), np.asarray(g, dtype=np.float64)
        return jax.pure_callback(host, shapes, w)
    return vag


@pytest.mark.parametrize("nan", [False, True], ids=["smooth", "nan_pullback"])
@pytest.mark.parametrize("iters", [1, 7, 60])
def test_cg_matches_jax(iters, nan):
    vag, x0 = _rosenbrock()
    if nan:
        vag = _nan_beyond(vag, 1.3)
    rp = TO.cg(vag, x0, max_iters=iters)
    rj = JO.cg(lambda w: vag(np.asarray(w)), x0, max_iters=iters)
    np.testing.assert_array_equal(rp.x, rj.x)
    assert (rp.obj, rp.iters, rp.func_evals) == (rj.obj, rj.iters, rj.func_evals)
    assert np.isfinite(rp.obj) and rp.obj <= vag(x0)[0]


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("iters", [1, 25, 400])
def test_gd_momentum_matches_jax(iters, momentum):
    vag, x0 = _rosenbrock()
    rp = TO.gd(vag, x0, max_iters=iters, learn_rate=1e-4, momentum=momentum)
    rj = JO.gd(jax.jit(_jax_vag(vag)), jnp.asarray(x0), max_iters=iters,
               learn_rate=1e-4, momentum=momentum)
    np.testing.assert_allclose(rp.x, np.asarray(rj.x), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rp.obj, float(rj.obj), rtol=1e-12)
    assert rp.iters == int(rj.iters)


def test_gd_stops_on_both_tolerances():
    """The stopping rule: |Δf| < obj_tol and max|Δx| < param_tol, from the
    first iteration on (gpc_tpu's gd compares against f(x0))."""
    vag, x0 = _rosenbrock()
    x0 = np.ones(6) + 1e-9
    rp = TO.gd(vag, x0, max_iters=100)
    rj = JO.gd(jax.jit(_jax_vag(vag)), jnp.asarray(x0), max_iters=100)
    assert rp.iters == int(rj.iters) == 1


@pytest.mark.parametrize("iters", [3, 40])
def test_gd_pullback_matches_jax(iters):
    vag, x0 = _rosenbrock()
    rp = TO.gd_pullback(vag, x0, max_iters=iters, learn_rate=1e-2)
    rj = JO.gd_pullback(lambda w: vag(np.asarray(w)), x0, max_iters=iters, learn_rate=1e-2)
    np.testing.assert_array_equal(rp.x, np.asarray(rj.x))
    assert rp.obj == float(rj.obj) and rp.iters == int(rj.iters)


@pytest.mark.parametrize("nan", [False, True], ids=["smooth", "nan"])
@pytest.mark.parametrize("iters", [2, 15, 200])
def test_lbfgs_native_matches_jax(iters, nan):
    assert TL.native_lib() is not None and JL._native_lib() is not None
    vag, x0 = _rosenbrock()
    if nan:
        vag = _nan_beyond(vag, 1.3)
    before = TL.ENGINE_RUNS["native"]
    rp = TO.lbfgs(vag, x0, max_iters=iters)
    assert TL.ENGINE_RUNS["native"] == before + 1
    rj = JO.lbfgs(lambda w: vag(np.asarray(w)), x0, max_iters=iters)
    np.testing.assert_array_equal(rp.x, rj.x)
    assert (rp.obj, rp.iters, rp.converged) == (rj.obj, rj.iters, rj.converged)
    if iters == 200 and not nan:
        assert rp.converged and np.allclose(rp.x, 1.0, atol=1e-5)


@pytest.mark.parametrize("iters", [2, 30])
def test_lbfgs_python_matches_jax(monkeypatch, iters):
    """Without the native engine (no C++ compiler) the two-loop fallback
    runs, as in gpc_tpu."""
    vag, x0 = _rosenbrock()
    monkeypatch.setattr(TL, "native_lib", lambda: None)
    before = TL.ENGINE_RUNS["python"]
    rp = TO.lbfgs(vag, x0, max_iters=iters)
    assert TL.ENGINE_RUNS["python"] == before + 1
    rj = JL._python_lbfgs(lambda w: vag(np.asarray(w)), np.asarray(x0, np.float64),
                          iters, 10, 1e-6)
    np.testing.assert_array_equal(rp.x, rj.x)
    assert (rp.obj, rp.iters, rp.converged) == (rj.obj, rj.iters, rj.converged)


def test_lbfgs_engine_builds_into_the_build_dir():
    """The engine is a copy of gpc_tpu's source, built by the port's one
    native-build helper into gpc_tpu_torch/_build/ under a name carrying
    the source's hash."""
    from gpc_tpu_torch.native import build
    so = build.library_path("lbfgs")
    assert so.parent.name == "_build" and so.parent.parent.name == "gpc_tpu_torch"
    assert so.exists() and so.name.startswith("liblbfgs_")
    assert build.SOURCES["lbfgs"] == "lbfgs.cpp"
    assert TL.native_lib() is build.load("lbfgs")


@pytest.mark.parametrize("name", ["conjgrad", "graddesc", "quasinew"])
def test_run_optimiser_dispatch(name):
    vag, x0 = _rosenbrock()
    rp = TO.run_optimiser(name, vag, x0, 5)
    rj = JO.run_optimiser(name, _jax_vag(vag) if name == "graddesc"
                          else (lambda w: vag(np.asarray(w))), jnp.asarray(x0), 5)
    np.testing.assert_allclose(rp.x, np.asarray(rj.x), rtol=1e-12, atol=1e-15)
    assert int(rp.iters) == int(rj.iters)


@pytest.mark.parametrize("name", ["conjgrad", "graddesc", "quasinew"])
def test_gp_optimise_matches_jax(name):
    """GP.optimise with each optimiser on the FTC objective: θ within 1e-8
    of gpc_tpu's after 4 iterations (the objectives differ in the last bits,
    XLA's Gram against the port's)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((60, 2))
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((60, 1))
    jk = GK.Cmpnd(input_dim=2, components=(GK.Rbf(input_dim=2), GK.Bias(input_dim=2),
                                           GK.White(input_dim=2)))
    tk = TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2), TK.Bias(input_dim=2),
                                           TK.White(input_dim=2)))
    jm, pm = JGP(jk, X, y), TGP(tk, X, y, device="cpu")
    rj = jm.optimise(iters=4, optimiser=name)
    rp = pm.optimise(iters=4, optimiser=name)
    np.testing.assert_allclose(pm.theta, np.asarray(jm.theta), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(rp.obj), float(rj.obj), rtol=1e-10)
    assert int(rp.iters) == int(rj.iters)
