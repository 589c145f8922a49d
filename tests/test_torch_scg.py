"""SCG, checkgrad and the optimiser dispatch of gpc_tpu_torch against gpc_tpu.

Both packages get the same float64 objective: gpc_tpu's jitted SCG reaches
the numpy objective through `jax.pure_callback`, so the two runs differ only
in SCG's own arithmetic (host numpy in the port, XLA in gpc_tpu).  Their
iterates are compared after every iteration (checkpoint segments of one
iteration) to 1e-12 relative.  Checkpoint files are read across packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gpc_tpu import optim as JO
from gpc_tpu.utils import checkpoint as JCK
from gpc_tpu_torch import optim as TO
from gpc_tpu_torch.utils import checkpoint as TCK

TRACE_KEYS = ("w", "r", "p", "old_obj", "lam", "lam_bar", "success", "iter")


def _quadratic(n=6, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, n))
    A = Z @ Z.T + n * np.eye(n)
    b = rng.standard_normal(n)

    def vag(w):
        w = np.asarray(w, dtype=np.float64)
        return 0.5 * w @ A @ w - b @ w, A @ w - b
    return vag


def _gp_objective():
    """The port's FTC objective on the CPU (float64), cmpnd(rbf, bias, white)."""
    from gpc_tpu_torch import kernels as TK
    from gpc_tpu_torch.models.gp import GP
    rng = np.random.default_rng(3)
    X = rng.standard_normal((80, 2))
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((80, 1))
    kern = TK.Cmpnd(input_dim=2, components=(
        TK.Rbf(input_dim=2), TK.Bias(input_dim=2), TK.White(input_dim=2)))
    model = GP(kern, X, y, device="cpu")
    return model.value_and_grad_fn(), model.theta


def _nan_beyond(vag, x0, dist):
    """vag, but NaN (value and gradient) once w[0] has moved more than
    `dist` from x0[0] along the first descent direction."""
    sign = -np.sign(vag(x0)[1][0])

    def f(w):
        v, g = vag(w)
        if sign * (w[0] - x0[0]) > dist:
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


def _trace(scg_checkpointed, vag, x0, iters):
    """The SCG state after each iteration, as float64 numpy."""
    states = []
    res = scg_checkpointed(vag, x0, max_iters=iters, ckpt_every=1,
                           on_checkpoint=lambda step, st: states.append(
                               {k: np.asarray(st[k], dtype=np.float64) for k in TRACE_KEYS}))
    return res, states


def _assert_same_trace(port, ref, rtol=1e-12):
    assert len(port) == len(ref) > 0
    for sp, sr in zip(port, ref):
        for k in TRACE_KEYS:
            np.testing.assert_allclose(sp[k], sr[k], rtol=rtol, atol=1e-300,
                                       err_msg=f"{k} at iteration {int(sr['iter'])}")


@pytest.mark.parametrize("case", ["quadratic", "gp", "nan_step"])
def test_scg_iterates_match_jax(case):
    if case == "quadratic":
        vag, x0 = _quadratic(), np.linspace(-1.0, 1.0, 6)
    else:
        vag, x0 = _gp_objective()
        if case == "nan_step":
            # the first trial step overshoots w[0] into the NaN region
            vag = _nan_beyond(vag, x0, 1e-3)
    res_p, tr_p = _trace(TO.scg_checkpointed, vag, x0, 50)
    res_j, tr_j = _trace(JO.scg_checkpointed, _jax_vag(vag), jnp.asarray(x0), 50)
    _assert_same_trace(tr_p, tr_j)
    assert res_p.iters == int(res_j.iters) and res_p.converged == bool(res_j.converged)
    np.testing.assert_allclose(res_p.x, np.asarray(res_j.x), rtol=1e-12)
    if case == "nan_step":
        success = [bool(s["success"]) for s in tr_p]
        assert not all(success) and np.isfinite(res_p.obj)
    # the monolithic run takes the identical trajectory
    res = TO.scg(vag, x0, max_iters=50)
    np.testing.assert_array_equal(res.x, res_p.x)
    assert res.iters == res_p.iters


def test_checkpointed_resume_matches_uninterrupted(tmp_path):
    vag, x0 = _gp_objective()
    full = TO.run_optimiser("scg", vag, x0, 30)
    ck = str(tmp_path / "scg.npz")
    TO.run_optimiser("scg", vag, x0, 12, ckpt_path=ck, ckpt_every=5)
    step, theta, extra, key = TCK.load(ck)
    assert step == 12 and key is None and int(extra["iter"]) == 12
    resumed = TO.run_optimiser("scg", vag, x0, 30, ckpt_path=ck, ckpt_every=5,
                               resume=True)
    np.testing.assert_array_equal(resumed.x, full.x)
    assert resumed.iters == full.iters and resumed.obj == full.obj


def test_checkpoint_files_cross_read(tmp_path):
    """gpc_tpu resumes from the port's checkpoint onto the port's
    trajectory, and the port reads gpc_tpu's file."""
    vag, x0 = _gp_objective()
    full = TO.scg(vag, x0, max_iters=20)
    port_ck = str(tmp_path / "port.npz")
    TO.run_optimiser("scg", vag, x0, 10, ckpt_path=port_ck, ckpt_every=10)
    step, theta, extra, key = JCK.load(port_ck)
    assert step == 10 and key is None
    res = JO.scg_checkpointed(_jax_vag(vag), jnp.asarray(x0), max_iters=20,
                              ckpt_every=10, resume_state=dict(extra, w=theta))
    np.testing.assert_allclose(np.asarray(res.x), full.x, rtol=1e-12)
    assert int(res.iters) == full.iters

    jax_ck = str(tmp_path / "jax.npz")
    JO.run_optimiser("scg", _jax_vag(vag), jnp.asarray(x0), 10,
                     ckpt_path=jax_ck, ckpt_every=10)
    resumed = TO.run_optimiser("scg", vag, x0, 20, ckpt_path=jax_ck, resume=True)
    np.testing.assert_allclose(resumed.x, full.x, rtol=1e-12)
    assert resumed.iters == full.iters


def test_checkpoint_save_load_keys(tmp_path):
    path = str(tmp_path / "c.npz")
    TCK.save(path, 7, np.arange(3.0), extra={"lam": np.float64(0.5), "success": True})
    with np.load(path) as z:
        assert sorted(z.files) == ["extra_lam", "extra_success", "step", "theta"]
    step, theta, extra, key = JCK.load(path)
    assert step == 7 and key is None and float(extra["lam"]) == 0.5
    np.testing.assert_array_equal(theta, np.arange(3.0))
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("name", ["conjgrad", "graddesc", "quasinew", "bogus"])
def test_unported_and_unknown_optimisers_raise(name):
    """An unknown name raises; conjgrad, graddesc and quasinew, once
    unported, now run (tests/test_torch_optim.py holds them to gpc_tpu's)
    and lower the objective."""
    vag = _quadratic()
    if name == "bogus":
        with pytest.raises(ValueError, match="Unrecognised optimiser"):
            TO.run_optimiser(name, vag, np.zeros(6), 5)
    else:
        res = TO.run_optimiser(name, vag, np.zeros(6), 5)
        assert np.isfinite(res.obj) and res.obj < vag(np.zeros(6))[0] and int(res.iters) > 0


def test_check_gradients_matches_jax(capsys):
    vag, x0 = _gp_objective()
    g_p, num_p, diff_p = TO.check_gradients(vag, x0)
    out = capsys.readouterr().out
    assert "Largest difference" in out
    g_j, num_j, diff_j = JO.check_gradients(_jax_vag(vag), x0, verbose=False)
    np.testing.assert_allclose(g_p, g_j, rtol=1e-15)
    np.testing.assert_allclose(num_p, num_j, rtol=1e-15)
    assert diff_p == diff_j and diff_p < 1e-5 * np.abs(g_p).max()
