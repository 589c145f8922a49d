"""The port's IVM (gpc_tpu_torch/models/ivm.py, serving.IvmServer, the IVM
model files, interop.from_jax.ivm_from_jax) against gpc_tpu's, in float64
on the CPU from the same numpy inputs (N = 200, d = 30, D ∈ {1, 2}).

Tolerances:
  * selection under entropy, random and rentropy (RefRng draws) for
    gaussian, probit, ncnm and ordered noise: the same order; the sites and
    the moments within 1e-10 of each field's largest entry (the rank-1
    products sum in another order; a Gaussian σ² of 0.01, since at the
    default 1e-6 the active points' ς cancels to σ²'s size and carries
    float64 rounding up by 1e6);
  * the active-set likelihood within rtol 1e-12, its gradient (autograd
    against jax.grad) within rtol 1e-9; the posterior within 1e-12 of its
    largest entry;
  * IVM.optimise for 2 external iterations: parameters within rtol 1e-8
    (SCG's curvature probe amplifies the objectives' last-bit differences,
    as in tests/test_torch_cli.py), and a resumed run replays the
    uninterrupted one bit for bit (also from gpc_tpu's checkpoint, within
    rtol 1e-8);
  * IvmServer against IVM.predict within 1e-12 of the largest entry (α
    against the solve of IVM.predict);
  * model files of every noise kind byte-equal across the packages, each
    reading the other's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu import noise as GZ
from gpc_tpu import priors as GP_
from gpc_tpu import transforms as GT
from gpc_tpu.io import model_io as JIO
from gpc_tpu.models import ivm as JI
from gpc_tpu_torch import noise as TZ
from gpc_tpu_torch.interop.from_jax import ivm_from_jax, kern_from_desc, noise_from_desc
from gpc_tpu_torch.io import model_io as TIO
from gpc_tpu_torch.models import ivm as TI
from gpc_tpu_torch.serving import IvmServer

N, D_ACTIVE = 200, 30


def _kern(q, lead="rbf", prior=False):
    first = {"rbf": GK.Rbf, "lin": GK.Lin, "mlp": GK.Mlp}[lead](input_dim=q)
    comps = [first, GK.Bias(input_dim=q), GK.White(input_dim=q)]
    if prior:
        comps = [c.with_priors([GP_.gamma(1.0, 1.0, index=c.n_params - 1)]) for c in comps]
    return GK.Cmpnd(input_dim=q, components=tuple(comps))


def _case(kind, seed=0):
    """(jax noise, X, y, noise params): q = 2, D = 2 for gaussian and ncnm."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, 2))
    lab = np.where(X[:, :1] + 0.5 * X[:, 1:] > 0, 1.0, -1.0)
    if kind == "gaussian":
        y = np.hstack([np.sin(2 * X[:, :1]), np.cos(X[:, 1:])])
        y = y + 0.05 * rng.standard_normal(y.shape)
        noise = GZ.GaussianNoise(output_dim=2)
        npar = np.array([0.1, -0.2, 0.01])
    elif kind == "probit":
        y = lab
        noise = GZ.ProbitNoise(output_dim=1)
        npar = noise.default_params(y)
    elif kind == "ncnm":
        y = np.hstack([lab, -lab])
        y[rng.uniform(size=(N, 2)) < 0.6] = 0.0
        noise = GZ.NcnmNoise(output_dim=2, split_gamma=True)
        npar = noise.default_params(y)
    else:
        y = np.digitize(X[:, :1] + 0.3 * rng.standard_normal((N, 1)), [-0.5, 0.5]).astype(float)
        y[::17] = np.nan
        noise = GZ.OrderedNoise(output_dim=1)
        npar = noise.default_params(y)
    return noise, X, y, npar


def _models(kind, selection=JI.ENTROPY, lead="rbf", seed=11, d=D_ACTIVE):
    noise, X, y, npar = _case(kind)
    jk = _kern(2, lead)
    jm = JI.IVM(jk, noise, X, y, num_active=d, selection=selection, seed=seed,
                noise_params=npar)
    tm = ivm_from_jax(jk, noise, X, y, d, jk.default_params(), npar, selection=selection,
                      seed=seed, device="cpu")
    return jm, tm


def _state_close(js, ts, tol=1e-10):
    np.testing.assert_array_equal(ts.active_idx.numpy(), np.asarray(js.active_idx))
    np.testing.assert_array_equal(ts.active_mask.numpy(), np.asarray(js.active_mask))
    for name in ("m_site", "beta_site", "mu", "varsigma", "nu", "g"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=name)


KINDS = ["gaussian", "probit", "ncnm", "ordered"]


@pytest.mark.parametrize("selection", [JI.ENTROPY, JI.RANDOM, JI.RENTROPY])
@pytest.mark.parametrize("kind", KINDS)
def test_select_points_matches_jax(kind, selection):
    """A selection pass, then a second one that continues the MT19937
    stream; gaussian takes lin (K4's plain version) as its kernel."""
    jm, tm = _models(kind, selection, lead="lin" if kind == "gaussian" else "rbf")
    for _ in range(2):
        _state_close(jm.init_and_select(), tm.init_and_select())


def test_select_points_function_matches_jax():
    """select_points as a function of (spec, params, X, y, draws)."""
    jm, tm = _models("probit", JI.RANDOM)
    rv = np.random.default_rng(2).uniform(size=D_ACTIVE)
    js = JI.select_points(jm.spec, jm.kern_params, jm.noise_params, jm.X, jm.y, rv)
    ts = TI.select_points(tm.spec, torch.as_tensor(tm.kern_params), torch.as_tensor(
        tm.noise_params), tm.Xd, tm.yd, rv)
    _state_close(js, ts)


def test_argmax_takes_the_first_maximum_and_nan_counts_as_maximum():
    """The pick's argmax semantics are gpc_tpu's: ties go to the first index
    (all scores tie at step 0 under a stationary kernel), and a NaN score
    is the maximum."""
    jm, tm = _models("probit")
    tm.init_and_select()
    c = tm._selector.c
    tm._selector.reset(tm.kern_params, tm.noise_params, np.zeros(D_ACTIVE))
    assert int(TI.pick_index(tm.spec, c)) == 0
    c["vs"][[7, 40]] = float("nan")
    assert int(TI.pick_index(tm.spec, c)) == 7
    want = jnp.argmax(jnp.asarray(TI.entropy_scores(tm.spec, c).numpy()))
    assert int(want) == 7


@pytest.mark.parametrize("selection", [JI.ENTROPY, JI.RANDOM])
def test_select_point_remove_matches_jax(selection):
    jm, tm = _models("ncnm")
    js, ts = jm.init_and_select(), tm.init_and_select()
    spec_j = dataclasses.replace(jm.spec, selection=selection)
    spec_t = dataclasses.replace(tm.spec, selection=selection)
    for r in (0.73, 0.9999999):
        got = TI.select_point_remove(spec_t, ts, r=r)
        want = JI.select_point_remove(spec_j, js, r=r)
        assert int(got[0]) == int(want[0]) and int(got[1]) == int(want[1])
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-10)
    if selection == JI.RANDOM:
        with pytest.raises(ValueError, match="random removal needs"):
            TI.select_point_remove(spec_t, ts)


@pytest.mark.parametrize("kind", ["gaussian", "ncnm"])
def test_active_log_likelihood_and_gradient_match_jax(kind):
    """Spherical (one structure, D = 2) and per-output structures, with
    gamma priors on every variance."""
    noise, X, y, npar = _case(kind)
    jk = _kern(2, prior=True)
    jm = JI.IVM(jk, noise, X, y, num_active=D_ACTIVE, noise_params=npar)
    js = jm.init_and_select()
    tk = kern_from_desc(jk)
    spec_t = TI.IvmSpec(kern=tk, noise=noise_from_desc(noise), n_data=N, input_dim=2,
                        output_dim=y.shape[1], num_active=D_ACTIVE)
    Xa = X[np.asarray(js.active_idx)]
    ms, bs = np.asarray(js.m_site), np.asarray(js.beta_site)
    a0 = np.asarray(GT.apply_xtoa(jk.transform_codes(), jnp.asarray(jk.default_params()))) + 0.1

    def jobj(a):
        return JI.active_log_likelihood(jm.spec, GT.apply_atox(jk.transform_codes(), a),
                                        jnp.asarray(Xa), jnp.asarray(ms), jnp.asarray(bs))
    want, want_g = jax.value_and_grad(jobj)(jnp.asarray(a0))
    from gpc_tpu_torch import transforms as TT
    a = torch.as_tensor(a0).requires_grad_(True)
    got = TI.active_log_likelihood(spec_t, TT.apply_atox(tk.transform_codes(), a),
                                   *(torch.as_tensor(np.array(v)) for v in (Xa, ms, bs)))
    (got_g,) = torch.autograd.grad(got, a)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind", ["gaussian", "ncnm"])
def test_posterior_and_out_match_jax(kind):
    jm, tm = _models(kind)
    jm.init_and_select()
    tm.init_and_select()
    Xt = np.random.default_rng(4).standard_normal((57, 2))
    mu_j, vs_j = (np.asarray(a) for a in jm.predict(Xt))
    mu_t, vs_t = tm.predict(Xt)
    for got, want in ((mu_t, mu_j), (vs_t, vs_j)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    out_j = np.asarray(jm.out(Xt))
    np.testing.assert_allclose(tm.out(Xt), out_j, rtol=0, atol=1e-12 * np.abs(out_j).max())


@pytest.mark.parametrize("kind", ["gaussian", "probit"])
def test_optimise_matches_jax(kind):
    """Two external iterations of the reselect/SCG alternation."""
    jm, tm = _models(kind, JI.RENTROPY, seed=5)
    jm.optimise(ext_iters=2, kern_iters=4, noise_iters=3)
    tm.optimise(ext_iters=2, kern_iters=4, noise_iters=3)
    np.testing.assert_allclose(tm.kern_params, np.asarray(jm.kern_params), rtol=1e-8)
    np.testing.assert_allclose(tm.noise_params, np.asarray(jm.noise_params), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(tm.state.active_idx.numpy(), np.asarray(jm.state.active_idx))
    assert tm.display().splitlines()[:4] == jm.display().splitlines()[:4]


def test_optimise_checkpoint_resume_replays_the_trajectory(tmp_path):
    """A run stopped after its first external iteration and resumed from
    its checkpoint ends where the uninterrupted run ends, bit for bit; the
    port also resumes from gpc_tpu's checkpoint (the same npz keys)."""
    kw = dict(kern_iters=3, noise_iters=2)
    _, full = _models("probit", JI.RENTROPY, seed=9)
    full.optimise(ext_iters=2, **kw)
    _, part = _models("probit", JI.RENTROPY, seed=9)
    ck = str(tmp_path / "ivm.npz")
    part.optimise(ext_iters=1, ckpt_path=ck, **kw)
    _, resumed = _models("probit", JI.RENTROPY, seed=9)
    resumed.optimise(ext_iters=2, ckpt_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(resumed.kern_params, full.kern_params)
    np.testing.assert_array_equal(resumed.noise_params, full.noise_params)
    jm, _ = _models("probit", JI.RENTROPY, seed=9)
    jck = str(tmp_path / "jax.npz")
    jm.optimise(ext_iters=1, ckpt_path=jck, **kw)
    _, cross = _models("probit", JI.RENTROPY, seed=9)
    cross.optimise(ext_iters=2, ckpt_path=jck, resume=True, **kw)
    np.testing.assert_allclose(cross.kern_params, full.kern_params, rtol=1e-8)


@pytest.mark.parametrize("kind", ["gaussian", "ncnm"])
def test_ivm_server_matches_predict(kind):
    """Chunks of 64 rows: 37 (one padded bucket), 64 and 150 (two chunks
    and a padded tail)."""
    _, tm = _models(kind)
    tm.init_and_select()
    server = IvmServer(tm, chunk=64)
    rng = np.random.default_rng(6)
    for T in (37, 64, 150):
        Xt = rng.standard_normal((T, 2))
        mu, vs = server.predict(Xt)
        want_mu, want_vs = tm.predict(Xt)
        assert mu.shape == vs.shape == (T, tm.spec.output_dim)
        np.testing.assert_allclose(mu, want_mu, rtol=0, atol=1e-12 * np.abs(want_mu).max())
        np.testing.assert_allclose(vs, want_vs, rtol=0, atol=1e-12 * np.abs(want_vs).max())
        want_out = tm.out(Xt)
        np.testing.assert_allclose(server.out(Xt), want_out, rtol=0,
                                   atol=1e-12 * np.abs(want_out).max())
    assert server.predict(np.zeros((0, 2)))[0].shape == (0, tm.spec.output_dim)


def test_ivm_from_jax_restores_the_state():
    jm, _ = _models("probit")
    js = jm.init_and_select()
    tm = ivm_from_jax(jm.spec.kern, jm.spec.noise, jm.X, jm.y, D_ACTIVE, jm.kern_params,
                      jm.noise_params, active_idx=np.asarray(js.active_idx),
                      m_site=np.asarray(js.m_site), beta_site=np.asarray(js.beta_site),
                      device="cpu")
    Xt = np.random.default_rng(8).standard_normal((20, 2))
    np.testing.assert_allclose(tm.predict(Xt)[0], np.asarray(jm.predict(Xt)[0]), rtol=1e-12)
    assert isinstance(tm.spec.noise, TZ.ProbitNoise)


@pytest.mark.parametrize("kind", KINDS)
def test_ivm_model_files_byte_equal(kind, tmp_path):
    """Each package writes the same bytes for the same model and reads the
    other's file to the same predictions."""
    jm, _ = _models(kind)
    js = jm.init_and_select()
    tm = ivm_from_jax(jm.spec.kern, jm.spec.noise, jm.X, jm.y, D_ACTIVE, jm.kern_params,
                      jm.noise_params, active_idx=np.asarray(js.active_idx),
                      m_site=np.asarray(js.m_site), beta_site=np.asarray(js.beta_site),
                      device="cpu")
    jf, tf = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    JIO.write_ivm(jf, jm, "Run as: test")
    TIO.write_ivm(tf, tm, "Run as: test")
    assert open(tf).read() == open(jf).read()
    back = TIO.read_ivm(jf, X=jm.X, y=jm.y, device="cpu")
    assert back.spec.noise == noise_from_desc(jm.spec.noise)
    Xt = np.random.default_rng(1).standard_normal((15, 2))
    np.testing.assert_allclose(back.predict(Xt)[0], np.asarray(jm.predict(Xt)[0]), rtol=1e-12)
    jback = JIO.read_ivm(tf)
    np.testing.assert_array_equal(np.asarray(jback.state.active_idx), np.asarray(js.active_idx))
    TIO.write_ivm(tf + "2", TIO.read_ivm(tf, device="cpu"))
    JIO.write_ivm(jf + "2", jback)
    assert open(tf + "2").read() == open(jf + "2").read()


@pytest.mark.parametrize("kind", ["probit", "ncnm", "ordered"])
def test_gp_model_file_keeps_its_noise(kind, tmp_path):
    """A GP model file's noise block (type, parameters, ncnm's gammaSplit,
    ordered's numCategories) reads and writes back byte for byte in both
    packages."""
    from gpc_tpu.models.gp import GP as JGP
    noise, X, y, npar = _case(kind)
    jg = JGP(_kern(2), X, np.nan_to_num(y[:, :1]))
    jg.noise_type, jg.noise_params = kind, np.asarray(npar)[:noise.n_params]
    jg.noise_extra = {"ncnm": {"gammaSplit": 1}, "ordered": {"numCategories": 3}}.get(kind, {})
    jf, tf = str(tmp_path / "jax_gp"), str(tmp_path / "port_gp")
    JIO.write_gp(jf, jg)
    tg = TIO.read_gp(jf, device="cpu")
    assert tg.noise_type == kind and tg.noise_extra == JIO.read_gp(jf).noise_extra
    TIO.write_gp(tf, tg)
    assert open(tf).read() == open(jf).read()
    JIO.write_gp(jf + "2", JIO.read_gp(tf))
    assert open(jf + "2").read() == open(jf).read()
