"""The port's FTC with K row-sharded (gpc_tpu_torch/parallel/dist_ftc.py)
on gloo at world sizes 1, 2 and 3 (tests/helpers/torch_dist2_worker.py,
case "ftc"), against gpc_tpu's make_dist_ftc_value_and_grad /
make_dist_ftc_posterior on its 8-virtual-device mesh and the port's
single-process GP, in float64.

N = 43 is ragged for every world, so the padding rows are the identity in
the sweep.  On every rank, to 1e-10 relative (θ̄: of its largest entry):
the objective and θ̄ with fixed and with learned scales; 5 SCG iterations
end at the single-process SCG's θ; the posterior of 37 rows equals
GP.predict and gpc_tpu's distributed posterior.  SCG's final objective is
held to 1e-8 (SCG_OBJ_TOL): at its endpoint the panel sweep's and the
dense jitchol's objectives differ by 1.7e-10 to 3.3e-10 relative (worlds
1-3) where θ agrees to 1.3e-11, the rounding of two factorization orders
of a K whose white variance SCG has driven down."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpc_tpu import kernels as GK
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.parallel.dist_ftc import make_dist_ftc_posterior as jax_posterior
from gpc_tpu.parallel.dist_ftc import make_dist_ftc_value_and_grad as jax_vag
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import pad_rows as jax_pad_rows
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch.models.gp import GP

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import cmpnd, spawn_worlds  # noqa: E402

WORLDS = (1, 2, 3)
N = 43
TOL = 1e-10
SCG_OBJ_TOL = 1e-8


def _inputs():
    rng = np.random.default_rng(31)
    X = rng.standard_normal((N, 3))
    y = np.column_stack([np.sin(X[:, 0]), np.cos(X[:, 1])]) + 0.05 * rng.standard_normal((N, 2))
    return dict(X=X, y=y, Xq=rng.standard_normal((37, 3)))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


def _port(learn=False):
    a = _inputs()
    return GP(cmpnd(3), a["X"], a["y"], centre=True, learn_scales=learn, scale_data=learn,
              device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_worlds("ftc", _inputs(), WORLDS, tmp_path_factory)


@pytest.fixture(scope="module")
def references():
    a = _inputs()
    X, y = a["X"], a["y"]
    kern = GK.Cmpnd(input_dim=3, components=(GK.Rbf(input_dim=3), GK.Bias(input_dim=3),
                                             GK.White(input_dim=3)))
    mesh = jax_mesh()
    nd = len(mesh.devices)
    Xp, _ = jax_pad_rows(X, nd)
    yp, _ = jax_pad_rows(y, nd)
    mask = np.zeros(Xp.shape[0])
    mask[:N] = 1.0
    args = [jax_shard_rows(mesh, v) for v in (Xp, yp, mask)]
    ref = {}
    for learn in (0, 1):
        jm = JGP(kern, X, y, centre=True, learn_scales=bool(learn), scale_data=bool(learn))
        np.testing.assert_array_equal(_port(bool(learn)).theta, np.asarray(jm.theta))
        f, g = jax.jit(jax_vag(jm.spec, mesh, jm.bias, jm.fixed_scales, N))(jm.theta, *args)
        ref[learn] = (float(f), np.asarray(g))
        if not learn:
            post = jax.jit(jax_posterior(jm.spec, mesh, jm.bias, jm.fixed_scales, N))
            mu, var = post(jm.theta, *args, jnp.asarray(a["Xq"]))
            ref["post"] = (np.asarray(mu), np.asarray(var))
    return ref


@pytest.mark.parametrize("learn", [0, 1])
@pytest.mark.parametrize("world", WORLDS)
def test_value_and_grad_match_single_process_and_gpc_tpu(runs, references, world, learn):
    f, g = _port(bool(learn)).value_and_grad_fn()(_port(bool(learn)).theta)
    jf, jg = references[learn]
    for r in runs[world]:
        _close(r[f"f{learn}"], f)
        _close(r[f"f{learn}"], jf)
        _close(r[f"g{learn}"], g)
        _close(r[f"g{learn}"], jg)


@pytest.mark.parametrize("world", WORLDS)
def test_scg_trajectory(runs, world):
    res = _port().optimise(iters=5)
    for r in runs[world]:
        assert int(r["scg_iters"]) == int(res.iters)
        _close(r["scg_x"], res.x)
        _close(r["scg_obj"], res.obj, SCG_OBJ_TOL)
    for r in runs[world][1:]:
        np.testing.assert_array_equal(r["scg_x"], runs[world][0]["scg_x"])


@pytest.mark.parametrize("world", WORLDS)
def test_posterior_matches_predict_and_gpc_tpu(runs, references, world):
    mu, var = _port().predict(_inputs()["Xq"])
    jmu, jvar = references["post"]
    for r in runs[world]:
        _close(r["mu"], mu)
        _close(r["var"], var)
        _close(r["mu"], jmu)
        _close(r["var"], jvar)
