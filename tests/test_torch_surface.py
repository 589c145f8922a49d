"""The last helpers of gpc_tpu's surface in gpc_tpu_torch, against gpc_tpu's, on
the CPU in float64:

  * linalg.pdinv; kernels.gram / cross / diag on cmpnd(rbf, bias, white):
    within 1e-10;
  * optim.scg_minimize on tests/test_scg.py's three problems (a quadratic,
    Rosenbrock, an objective that is NaN outside a basin), at its
    tolerances, and its iterates against gpc_tpu's within 1e-8;
  * parallel.dist_gplvm.dryrun and parallel.dist_ivm.dryrun at gloo worlds
    1 and 2 (tests/helpers/torch_dist2_worker.py, case "dryrun"): each rank
    passes its checks and prints gpc_tpu's lines, with the values gpc_tpu's
    own dryruns print on its 1- and 2-device meshes (to the 6 decimals
    printed); scaling_bench.collective_stats returns gpc_tpu's shape
    {op: {"count", "bytes"}} with the calls and bytes made;
  * utils.profiling: sync, trace, measure_rtt, time_fn, evidence_flops and
    step_report (the last two equal to gpc_tpu's);
  * ops.chol_pallas.chol_inv_block_fused, K5 under gpc_tpu's other name.
"""

import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu import linalg as JLA
from gpc_tpu.optim.scg import scg_minimize as j_scg_minimize
from gpc_tpu.utils import profiling as JPR
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch import linalg as TLA
from gpc_tpu_torch.optim import scg_minimize
from gpc_tpu_torch.utils import profiling as TPR

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import spawn_worlds  # noqa: E402

WORLDS = (1, 2)


def test_pdinv():
    B = np.random.default_rng(4).standard_normal((10, 10))
    A = B @ B.T + 10 * np.eye(10)
    got = TLA.pdinv(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(JLA.pdinv(jnp.asarray(A))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, np.linalg.inv(A), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(got, got.T)


def test_gram_cross_diag():
    q = 3
    rng = np.random.default_rng(5)
    X1, X2 = rng.standard_normal((7, q)), rng.standard_normal((5, q))
    jk, tk = (mod.Cmpnd(input_dim=q, components=(mod.Rbf(input_dim=q), mod.Bias(input_dim=q),
                                                 mod.White(input_dim=q))) for mod in (GK, TK))
    p = jk.default_params() * np.exp(0.3 * rng.standard_normal(jk.n_params))
    pt, pj = torch.as_tensor(p), jnp.asarray(p)
    for got, want in ((TK.gram(tk, pt, torch.as_tensor(X1)), GK.gram(jk, pj, jnp.asarray(X1))),
                      (TK.cross(tk, pt, torch.as_tensor(X1), torch.as_tensor(X2)),
                       GK.cross(jk, pj, jnp.asarray(X1), jnp.asarray(X2))),
                      (TK.diag(tk, pt, torch.as_tensor(X1)), GK.diag(jk, pj, jnp.asarray(X1)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def _quadratic(xp):
    A = xp.asarray(np.diag([1.0, 10.0, 100.0]))
    b = xp.asarray(np.array([1.0, -2.0, 3.0]))
    return lambda x: 0.5 * x @ A @ x - b @ x


def _rosenbrock(xp):
    return lambda x: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _nan_outside(xp):
    where = torch.where if xp is torch else jnp.where
    nan = torch.tensor(float("nan"), dtype=torch.float64) if xp is torch else jnp.nan

    def f(x):
        v = xp.sum(x * x)
        return where(v < 100.0, v + xp.log(4.0 - x[0]), nan)
    return f


SCG_CASES = {"quadratic": (_quadratic, [0.0, 0.0, 0.0], 200),
             "rosenbrock": (_rosenbrock, [-1.2, 1.0], 1000),
             "nan": (_nan_outside, [3.0, 1.0], 300)}


@pytest.mark.parametrize("case", sorted(SCG_CASES))
def test_scg_minimize(case):
    make, x0, iters = SCG_CASES[case]
    res = scg_minimize(make(torch), np.array(x0), max_iters=iters, jit=True)
    if case == "quadratic":
        np.testing.assert_allclose(res.x, np.linalg.solve(np.diag([1.0, 10.0, 100.0]),
                                                          [1.0, -2.0, 3.0]), rtol=1e-4, atol=1e-5)
        assert bool(res.converged)
    elif case == "rosenbrock":
        np.testing.assert_allclose(res.x, [1.0, 1.0], atol=2e-3)
    else:
        f0 = float(make(torch)(torch.tensor(x0, dtype=torch.float64)))
        assert np.isfinite(float(res.obj)) and float(res.obj) <= f0
    want = j_scg_minimize(make(jnp), jnp.asarray(x0), max_iters=iters)
    np.testing.assert_allclose(res.x, np.asarray(want.x), rtol=1e-8, atol=1e-10)
    assert int(res.iters) == int(want.iters)


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    return spawn_worlds("dryrun", {"none": np.zeros(1)}, WORLDS, tmp_path_factory)


def _numbers(lines):
    return [float(v) for v in re.findall(r"value\+grad (-?[\d.]+) matches single-chip (-?[\d.]+)",
                                         lines) for v in v]


@pytest.mark.parametrize("world", WORLDS)
def test_dryruns_match_gpc_tpu(dryruns, world, capsys):
    from gpc_tpu.parallel import dist_gplvm, dist_ivm
    from gpc_tpu.parallel.mesh import data_mesh

    capsys.readouterr()
    dist_gplvm.dryrun(data_mesh(world), world)
    dist_ivm.dryrun(data_mesh(world), world)
    want = capsys.readouterr().out
    lines = str(dryruns[world][0]["lines"])
    assert lines.count("OK") == 4 and lines.count("distributed IVM selection order") == 1
    got, ref = _numbers(lines), _numbers(want)
    assert len(got) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert [str(r["lines"]) for r in dryruns[world][1:]] == [""] * (world - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_stats(dryruns, world):
    for r in dryruns[world]:
        stats = json.loads(str(r["stats"]))
        assert stats == {"all-reduce": {"count": 1, "bytes": 48},
                         "all-gather": {"count": 1, "bytes": 48 * world}}


def test_profiling_helpers(tmp_path):
    x = torch.arange(4.0) + 2.0
    assert TPR.sync((x, {"a": 1})) == 2.0
    assert TPR.measure_rtt(samples=2, device="cpu") >= 0.0
    assert TPR.time_fn(lambda a: a * 2.0, x, reps=2) > 0
    with TPR.trace(str(tmp_path)):
        (x @ x).item()
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())
    assert TPR.evidence_flops(100, 2, 1) == JPR.evidence_flops(100, 2, 1)
    for flops in (None, 2.0e9):
        assert TPR.step_report("ev", 0.0125, flops) == JPR.step_report("ev", 0.0125, flops)


def test_chol_inv_block_fused():
    """K5 under the name of gpc_tpu's fused kernel: its plain version here
    (Cholesky and a triangular solve, float64) against LAPACK within 1e-10
    and against gpc_tpu's kernel in interpret mode within 1e-6 (that
    kernel's float64 factor is 5.8e-8 from LAPACK's at this n); n not a
    multiple of 128 raises."""
    from gpc_tpu.ops.chol_pallas import chol_inv_block_fused as j_fused
    from gpc_tpu_torch.ops.chol_pallas import chol_inv_block_fused

    B = np.random.default_rng(8).standard_normal((256, 256))
    A = B @ B.T / 256 + 0.5 * np.eye(256)
    L, M = chol_inv_block_fused(torch.as_tensor(A))
    jL, jM = j_fused(jnp.asarray(A), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.numpy() @ L.numpy(), np.eye(256), rtol=0, atol=1e-10)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=1e-6)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        chol_inv_block_fused(torch.eye(200, dtype=torch.float64))
