"""The port's distributed layer (gpc_tpu_torch/parallel/: mesh, multihost,
dist_gp, and GPServer(mesh=)) on gloo, against gpc_tpu's make_dist_objective
on its 8-virtual-device mesh (tests/conftest.py) and the port's
single-process model.

World sizes 1, 2 and 3, each rank a process of its own
(tests/helpers/torch_dist_worker.py) joined through
multihost.initialize_from_env with a file:// store under tmp_path (no TCP
port, so parallel test workers never collide).  N = 43 is ragged for every
world size, so the padding rows are exercised.  In float64 on the CPU:
the objective and θ̄ for FTC, DTC, DTCVAR and FITC equal both references
to 1e-10 relative (θ̄: of its largest entry) on every rank; 5 iterations of
make_dist_train_step end where the single-process SCG ends (1e-10) on every
rank; load_svml_sharded's blocks are read_svml's rows, padded with zeros on
the last ranks; GPServer(mesh=) equals GPServer to 1e-12 on requests of 37
and 5 rows (chunks of 8 × world, ragged tails), with buckets rounded to the
world size."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpc_tpu import kernels as GK
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu.parallel.dist_gp import make_dist_objective as jax_dist_objective
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import pad_rows as jax_pad_rows
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch.io.svml import read_svml, write_svml
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.parallel import mesh as TMESH
from gpc_tpu_torch.parallel import multihost
from gpc_tpu_torch.serving import GPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "helpers", "torch_dist_worker.py")
APPROXES = ("ftc", "dtc", "dtcvar", "fitc")
WORLDS = (1, 2, 3)
N = 43


def _data():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((N, 3))
    y = np.column_stack([np.sin(X[:, 0]), np.cos(X[:, 1])]) + 0.05 * rng.standard_normal((N, 2))
    Xq = rng.standard_normal((37, 3))
    return X, y, Xq


def _kw(approx):
    return dict(num_active=9, beta=2.0, seed=5) if approx != "ftc" else {}


def _port_model(approx, X, y):
    kern = KM.Cmpnd(input_dim=3, components=(KM.Rbf(input_dim=3), KM.Bias(input_dim=3),
                                             KM.White(input_dim=3)))
    return GP(kern, X, y, approx=approx, centre=True, device="cpu", **_kw(approx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, the workers of each world
    size run once for the module."""
    X, y, Xq = _data()
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        np.savez(d / "data.npz", X=X, y=y, Xq=Xq)
        write_svml(d / "data.svml", X, y[:, :1])
        procs = []
        for rank in range(world):
            env = dict(os.environ, GPC_TPU_COORDINATOR=f"file://{d / 'store'}",
                       GPC_TPU_NUM_PROCS=str(world), GPC_TPU_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(d / "data.npz"), str(d / "data.svml"),
                 str(d / f"out{rank}.npz")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            for p in procs:
                _, err = p.communicate(timeout=240)
                assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        out[world] = [dict(np.load(d / f"out{r}.npz")) for r in range(world)]
    return out


@pytest.fixture(scope="module")
def references():
    """{approx: (single-process f, θ̄, gpc_tpu's distributed f, θ̄)}."""
    X, y, _ = _data()
    kern = GK.Cmpnd(input_dim=3, components=(GK.Rbf(input_dim=3), GK.Bias(input_dim=3),
                                             GK.White(input_dim=3)))
    mesh = jax_mesh()
    ref = {}
    for approx in APPROXES:
        pm = _port_model(approx, X, y)
        jm = JGP(kern, X, y, approx=approx, centre=True, **_kw(approx))
        np.testing.assert_array_equal(pm.theta, np.asarray(jm.theta))
        f, g = pm.value_and_grad_fn()(pm.theta)
        ndev = len(mesh.devices)
        Xp, _ = jax_pad_rows(X, ndev)
        yp, _ = jax_pad_rows(y, ndev)
        mask = np.zeros(Xp.shape[0])
        mask[:N] = 1.0
        nlml = jax_dist_objective(jm.spec, mesh, jm.bias, jm.fixed_scales, N)
        args = [jax_shard_rows(mesh, a) for a in (Xp, yp, mask)]
        jf, jg = jax.jit(jax.value_and_grad(nlml))(jnp.asarray(jm.theta), *args)
        ref[approx] = (f, g, float(jf), np.asarray(jg))
    return ref


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("approx", APPROXES)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_objective_and_gradient(runs, references, world, approx):
    f, g, jf, jg = references[approx]
    for r in runs[world]:
        _close(r[f"{approx}_f"], f)
        _close(r[f"{approx}_f"], jf)
        _close(r[f"{approx}_g"], g)
        _close(r[f"{approx}_g"], jg)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_scg_trajectory(runs, world):
    X, y, _ = _data()
    for approx in ("dtc", "ftc"):
        m = _port_model(approx, X, y)
        res = m.optimise(iters=5)
        for r in runs[world]:
            assert int(r[f"scg_{approx}_iters"]) == int(res.iters)
            _close(r[f"scg_{approx}_x"], res.x)
            _close(r[f"scg_{approx}_obj"], res.obj)
        # every rank takes the same trajectory, bit for bit
        for r in runs[world][1:]:
            np.testing.assert_array_equal(r[f"scg_{approx}_x"], runs[world][0][f"scg_{approx}_x"])


@pytest.mark.parametrize("world", WORLDS)
def test_load_svml_sharded(runs, world):
    X, y, _ = _data()
    Xs, ys = [], []
    for rank, r in enumerate(runs[world]):
        assert int(r["svml_n"]) == N
        lo, hi = r["row_range"]
        assert (lo, hi) == (rank * r["svml_X"].shape[0], (rank + 1) * r["svml_X"].shape[0])
        Xs.append(r["svml_X"])
        ys.append(r["svml_y"])
    Xw, yw = TMESH.pad_rows(X, world)[0], TMESH.pad_rows(y[:, :1], world)[0]
    np.testing.assert_array_equal(np.concatenate(Xs), Xw)
    np.testing.assert_array_equal(np.concatenate(ys), yw)


@pytest.mark.parametrize("world", WORLDS)
def test_gpserver_mesh(runs, world):
    X, y, Xq = _data()
    for approx in ("ftc", "fitc"):
        server = GPServer(_port_model(approx, X, y), chunk=8 * world)
        for rows in (37, 5):
            mu, var = server.predict(Xq[:rows])
            for r in runs[world]:
                _close(r[f"serve_{approx}_{rows}_mu"], mu, 1e-12)
                _close(r[f"serve_{approx}_{rows}_var"], var, 1e-12)
        # the next power of two, capped at the chunk, rounded up to the world
        want = [-(-min(1 << (t - 1).bit_length(), 8 * world) // world) * world
                for t in (1, 3, 5, 8, 13)]
        for r in runs[world]:
            assert r[f"bucket_{approx}"].tolist() == want


def test_single_process_entry_points(tmp_path, monkeypatch):
    """No group: initialize_from_env does nothing, data_mesh refuses; the
    helpers split rows as gpc_tpu's do; half a coordinator is an error."""
    for k in ("GPC_TPU_COORDINATOR", "GPC_TPU_NUM_PROCS", "GPC_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert multihost.initialize_from_env(device="cpu") is False
    with pytest.raises(RuntimeError, match="no process group"):
        TMESH.data_mesh("cpu")
    monkeypatch.setenv("GPC_TPU_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="GPC_TPU_COORDINATOR"):
        multihost.initialize_from_env(device="cpu")
    # the card unless asked for the CPU: without one, no fallback
    monkeypatch.setenv("GPC_TPU_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        multihost.initialize_from_env()
    assert not dist.is_initialized()
    X = np.arange(10.0).reshape(5, 2)
    got, n = TMESH.pad_rows(X, 4)
    want, nj = jax_pad_rows(X, 4)
    assert n == nj == 5
    np.testing.assert_array_equal(got, want)
    mesh = TMESH.Mesh(group=None, rank=1, size=4, device=torch.device("cpu"))
    np.testing.assert_array_equal(TMESH.shard_rows(mesh, got).numpy(), got[2:4])
    np.testing.assert_array_equal(TMESH.replicated(mesh, got).numpy(), got)
    assert multihost.process_row_range(8, mesh) == (2, 4)
    with pytest.raises(ValueError, match="pad rows"):
        multihost.process_row_range(7, mesh)
    assert TMESH.backend_for("cpu") == "gloo" and TMESH.backend_for("cuda") == "nccl"
    assert TMESH.DATA_AXIS == "dp"
