"""The port's row-sharded matrix-free evidence
(gpc_tpu_torch/parallel/dist_iterative.py) on gloo at world sizes 1, 2 and
3 (tests/helpers/torch_dist2_worker.py, case "iterative"), against
gpc_tpu's make_dist_iterative_evidence on its 8-virtual-device mesh and the
port's single-process engine (ops/iterative.py), in float64.

The data of tests/test_dist_iterative.py, at N = 48 where it must split
over 1, 2, 3 and 8 ranks.
  * gpc_tpu's probes injected (its jax.random draw under fold_in(key, N)):
    logdet and quad within 1e-8 of gpc_tpu's, (p̄, X̄, m̄) within 1e-6
    relative and 1e-8 absolute, gpc_tpu's own CG tolerances for
    distributed-against-single (test_dist_iterative.py).
  * The port's own probes (the seeded draw of its single-process engine):
    the same estimator as kern_evidence_iterative, value and gradients
    within 1e-10 (relative to each's largest entry).
  * Ragged N = 43: the padding rows act as the identity, the value equals
    the single-process masked engine on the padded operator within 1e-10
    and quad the dense mᵀK⁻¹m within 1e-7 (CG tolerance).
  * Preconditioned (rank 24, 25 CG iterations, white 1e-4): quad within
    1e-8 of the single process's and of gpc_tpu's, within 1e-6 of the
    dense value, and ten times nearer it than plain CG's at 25 iterations.
  * dist_iterative_nlml: value and θ̄ within 1e-10 of the single-process
    objective on the same probes; 5 SCG iterations end where the
    single-process SCG ends (1e-8: CG's tolerance through SCG's
    finite-difference probe)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu.ops.iterative import IterConfig as JIterConfig
from gpc_tpu.parallel.dist_iterative import make_dist_iterative_evidence as jax_evidence
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch import ndlutil
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.ops import iterative as TI
from gpc_tpu_torch.optim import numpy_value_and_grad, scg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import cmpnd, spawn_worlds  # noqa: E402

WORLDS = (1, 2, 3)
N = 48
TOL = 1e-10
CFG = (32, 8, 24, 200, 0, 8, 0)          # IterConfig: block, probes, lanczos, cg, precond, T, seed
CFG_PRE = (32, 8, 24, 25, 24, 8, 0)
CFG_PLAIN25 = (32, 8, 24, 25, 0, 8, 0)


def jax_probes(seed, n, T, P):
    """gpc_tpu's probe draw (as tests/test_torch_iterative.py derives it)."""
    k_tr, k_slq = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), n))
    Ztr = np.asarray(jax.random.rademacher(k_tr, (n, T), dtype=jnp.float64))
    Zs = [np.asarray(jax.random.rademacher(k, (n,), dtype=jnp.float64))
          for k in jax.random.split(k_slq, P)]
    return Ztr.copy(), np.stack(Zs, axis=1)


def _inputs():
    rng = np.random.default_rng(5)
    X, m = rng.standard_normal((N, 2)), rng.standard_normal((N, 2))
    rng6 = np.random.default_rng(6)
    Xr, mr = rng6.standard_normal((43, 2)), rng6.standard_normal((43, 2))
    rng9 = np.random.default_rng(9)
    Xs = rng9.standard_normal((N, 2))
    ys = np.sin(Xs[:, :1]) + 0.1 * rng9.standard_normal((N, 1))
    Ztr, Zslq = jax_probes(0, N, 8, 8)
    return dict(X=X, m=m, p=np.array([1.2, 0.9, 0.2, 0.3]), Xr=Xr, mr=mr,
                p_hard=np.array([0.4, 1.0, 0.2, 1e-4]), Xs=Xs, ys=ys, Ztr=Ztr, Zslq=Zslq,
                cfg=np.array(CFG), cfg_pre=np.array(CFG_PRE),
                cfg_plain25=np.array(CFG_PLAIN25))


def _close(got, want, tol=TOL, atol=None):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.max(np.abs(want)) if atol is None else atol)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).clone().requires_grad_(True)


def _single(X, m, p, cfg, probes=None, mask=None):
    """(logdet, quad, p̄, X̄, m̄) of ld + quad from the single-process engine."""
    pt, Xt, mt = _t(p), _t(X), _t(m)
    cfg = TI.IterConfig(*cfg)
    if mask is None:
        ld, quad = TI.kern_evidence_iterative(cmpnd(2), pt, Xt, mt, cfg, probes=probes)
    else:
        ld, quad = TI.kern_evidence_iterative_masked(cmpnd(2), pt, Xt, mt,
                                                     torch.as_tensor(mask), cfg)
    grads = torch.autograd.grad(ld + quad, (pt, Xt, mt))
    return (float(ld), float(quad)) + tuple(g.numpy() for g in grads)


def _dist(runs, world, tag):
    rs = runs[world]
    return (rs, np.concatenate([r[f"{tag}_gX"] for r in rs]),
            np.concatenate([r[f"{tag}_gm"] for r in rs]))


def _single_nlml(a):
    """The single-process FTC objective over the same engine and probes."""
    X, y = a["Xs"], a["ys"]
    model = GP(cmpnd(2), X, y, centre=True, device="cpu")
    kern = model.spec.kern
    Xt = torch.as_tensor(X)
    m = (torch.as_tensor(y) - torch.as_tensor(model.bias)) / torch.as_tensor(model.fixed_scales)

    def nlml(theta):
        kp = tr.apply_atox(kern.transform_codes(), theta)
        ld, quad = TI.kern_evidence_iterative(kern, kp, Xt, m, TI.IterConfig(*CFG))
        return 0.5 * (quad + ld) + N * ndlutil.HALFLOGTWOPI
    return model, nlml


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_worlds("iterative", _inputs(), WORLDS, tmp_path_factory)


@pytest.fixture(scope="module")
def references():
    a = _inputs()
    kern = GK.Cmpnd(input_dim=2, components=(GK.Rbf(input_dim=2), GK.Bias(input_dim=2),
                                             GK.White(input_dim=2)))
    mesh = jax_mesh()
    mask = jax_shard_rows(mesh, np.ones(N))
    ref = {}
    for tag, p, cfg in (("jax", a["p"], CFG), ("pre", a["p_hard"], CFG_PRE)):
        ev = jax_evidence(kern, mesh, JIterConfig(*cfg))

        def obj(p_, X_, m_):
            ld, quad = ev(p_, X_, m_, mask)
            return ld + quad, (ld, quad)
        (_, (ld, quad)), g = jax.value_and_grad(obj, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(p), jax_shard_rows(mesh, a["X"]), jax_shard_rows(mesh, a["m"]))
        ref[tag] = (float(ld), float(quad)) + tuple(np.asarray(x) for x in g)
    return ref


@pytest.mark.parametrize("world", WORLDS)
def test_gpc_tpu_probes_match_gpc_tpu(runs, references, world):
    ld, quad, gp, gX, gm = references["jax"]
    rs, dX, dm = _dist(runs, world, "jax")
    for r in rs:
        _close(r["jax_ld"], ld, 1e-8, 0.0)
        _close(r["jax_quad"], quad, 1e-8, 0.0)
        _close(r["jax_gp"], gp, 1e-6, 1e-8)
    _close(dX, gX, 1e-6, 1e-8)
    _close(dm, gm, 1e-6, 1e-8)


@pytest.mark.parametrize("tag", ["jax", "own"])
@pytest.mark.parametrize("world", WORLDS)
def test_same_probes_same_estimator_as_single_process(runs, world, tag):
    a = _inputs()
    probes = (a["Ztr"], a["Zslq"]) if tag == "jax" else None
    ld, quad, gp, gX, gm = _single(a["X"], a["m"], a["p"], CFG, probes)
    rs, dX, dm = _dist(runs, world, tag)
    for r in rs:
        _close(r[f"{tag}_ld"], ld)
        _close(r[f"{tag}_quad"], quad)
        _close(r[f"{tag}_gp"], gp)
    _close(dX, gX)
    _close(dm, gm)


@pytest.mark.parametrize("world", WORLDS)
def test_padded_rows_are_identity(runs, world):
    from gpc_tpu_torch.parallel.mesh import pad_rows
    a = _inputs()
    Xp, _ = pad_rows(a["Xr"], world)
    mp, _ = pad_rows(a["mr"], world)
    mask = np.zeros(Xp.shape[0])
    mask[:43] = 1.0
    ld, quad, gp, gX, gm = _single(Xp, mp, a["p"], CFG, mask=mask)
    K = cmpnd(2).gram(torch.as_tensor(a["p"]), torch.as_tensor(a["Xr"])).numpy()
    quad_exact = float(np.sum(a["mr"] * np.linalg.solve(K, a["mr"])))
    rs, dX, dm = _dist(runs, world, "ragged")
    for r in rs:
        _close(r["ragged_ld"], ld)
        _close(r["ragged_quad"], quad)
        _close(r["ragged_quad"], quad_exact, 1e-7)
        _close(r["ragged_gp"], gp)
    _close(dX, gX)
    _close(dm, gm)
    assert np.all(dX[43:] == 0.0) and np.all(dm[43:] == 0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_preconditioned_path(runs, references, world):
    a = _inputs()
    _, quad_s, *_ = _single(a["X"], a["m"], a["p_hard"], CFG_PRE)
    K = cmpnd(2).gram(torch.as_tensor(a["p_hard"]), torch.as_tensor(a["X"])).numpy()
    quad_exact = float(np.sum(a["m"] * np.linalg.solve(K, a["m"])))
    for r in runs[world]:
        _close(r["pre_quad"], quad_s, 1e-8)
        _close(r["pre_quad"], references["pre"][1], 1e-8)
        err_p = abs(r["pre_quad"] - quad_exact) / abs(quad_exact)
        err_0 = abs(r["plain25_quad"] - quad_exact) / abs(quad_exact)
        assert err_p < 1e-6 and err_p < 0.1 * err_0, (err_p, err_0)


@pytest.mark.parametrize("world", WORLDS)
def test_nlml_and_scg_match_single_process(runs, world):
    model, nlml = _single_nlml(_inputs())
    vag = numpy_value_and_grad(nlml, "cpu")
    f, g = vag(model.theta)
    res = scg(vag, model.theta, max_iters=5)
    for r in runs[world]:
        _close(r["nlml_f"], f)
        _close(r["nlml_g"], g)
        assert int(r["scg_iters"]) == int(res.iters)
        _close(r["scg_x"], res.x, 1e-8)
        _close(r["scg_obj"], res.obj, 1e-8)
        assert r["scg_obj"] < f
