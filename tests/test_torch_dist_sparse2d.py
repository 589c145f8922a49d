"""The port's sparse evidences on the 2-D (mp, dp) mesh
(gpc_tpu_torch/parallel/dist_sparse2d.py, parallel/mesh.mesh_2d) on gloo
at 1×1, 2×1, 1×2 and 2×2 (tests/helpers/torch_dist2_worker.py, case
"sparse2d"), against gpc_tpu's make_dist2d_objective on its 2×4 mesh of
virtual devices and the port's single-process sparse GP, in float64.

N = 45 is ragged over dp = 2, M = 12 splits over mp = 2.  For DTC, DTCVAR
and FITC, on every rank: the objective and θ̄ within 1e-10 relative (θ̄:
of its largest entry) of both references (gpc_tpu's non-whitened form
against the single process's whitened one); 5 SCG iterations (the fewest
after which every approximation has left its start: at 3, DTC's and FITC's
steps are still all rejected) end where the single-process SCG ends (1e-8:
the two forms' last-bit differences through SCG's finite-difference
curvature probe)."""

import os
import sys

import jax
import numpy as np
import pytest

from gpc_tpu import kernels as GK
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.parallel.dist_sparse2d import make_dist2d_objective as jax_objective
from gpc_tpu.parallel.dist_sparse2d import mesh_2d as jax_mesh_2d
from gpc_tpu.parallel.dist_sparse2d import shard_data_2d as jax_shard_2d
from gpc_tpu.parallel.mesh import pad_rows as jax_pad_rows
from gpc_tpu_torch.models.gp import GP

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import cmpnd, spawn_worlds  # noqa: E402

GRIDS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
APPROXES = ("dtc", "dtcvar", "fitc")
N, M = 45, 12
TOL = 1e-10
SCG_TOL = 1e-8


def _inputs():
    rng = np.random.default_rng(31)
    X = rng.standard_normal((N, 3))
    y = np.column_stack([np.sin(X[:, 0]), np.cos(X[:, 1])]) + 0.05 * rng.standard_normal((N, 2))
    return dict(X=X, y=y, M=np.array(M))


def _port(approx):
    a = _inputs()
    return GP(cmpnd(3), a["X"], a["y"], approx=approx, num_active=M, beta=2.0, seed=7,
              device="cpu")


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_worlds("sparse2d", _inputs(), list(GRIDS), tmp_path_factory, grid=GRIDS)


@pytest.fixture(scope="module")
def references():
    a = _inputs()
    kern = GK.Cmpnd(input_dim=3, components=(GK.Rbf(input_dim=3), GK.Bias(input_dim=3),
                                             GK.White(input_dim=3)))
    mesh = jax_mesh_2d(2, 4)
    Xp, _ = jax_pad_rows(a["X"], 4)
    yp, _ = jax_pad_rows(a["y"], 4)
    mask = np.zeros(Xp.shape[0])
    mask[:N] = 1.0
    args = [jax_shard_2d(mesh, v) for v in (Xp, yp, mask)]
    ref = {}
    for approx in APPROXES:
        jm = JGP(kern, a["X"], a["y"], approx=approx, num_active=M, beta=2.0, seed=7)
        pm = _port(approx)
        np.testing.assert_array_equal(pm.theta, np.asarray(jm.theta))
        nlml = jax_objective(jm.spec, mesh, jm.bias, jm.fixed_scales, N)
        f, g = jax.jit(jax.value_and_grad(nlml))(jm.theta, *args)
        ref[approx] = (float(f), np.asarray(g))
    return ref


@pytest.mark.parametrize("approx", APPROXES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_value_and_grad_match_single_process_and_gpc_tpu(runs, references, grid, approx):
    pm = _port(approx)
    f, g = pm.value_and_grad_fn()(pm.theta)
    jf, jg = references[approx]
    for r in runs[grid]:
        _close(r[f"{approx}_f"], f)
        _close(r[f"{approx}_f"], jf)
        _close(r[f"{approx}_g"], g)
        _close(r[f"{approx}_g"], jg)


@pytest.mark.parametrize("approx", APPROXES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_scg_steps(runs, grid, approx):
    pm = _port(approx)
    start = pm.value_and_grad_fn()(pm.theta)[0]
    res = pm.optimise(iters=5)
    for r in runs[grid]:
        assert int(r[f"{approx}_scg_iters"]) == int(res.iters)
        assert np.isfinite(r[f"{approx}_scg_obj"]) and r[f"{approx}_scg_obj"] < start
        _close(r[f"{approx}_scg_x"], res.x, SCG_TOL)
        _close(r[f"{approx}_scg_obj"], res.obj, SCG_TOL)
