"""The port's panel Cholesky (gpc_tpu_torch/parallel/chol_distributed.py)
on gloo at world sizes 1, 2 and 3, each rank a process of its own
(tests/helpers/torch_dist2_worker.py, case "chol"), against gpc_tpu's
chol_distributed / evidence_distributed on its 8-virtual-device mesh and
against the dense single-process route (torch.linalg, float64).

N = 48 splits evenly over every world.  On every rank, to 1e-10 relative:
the row-sharded factor equals torch.linalg.cholesky and gpc_tpu's; the
fused evidence's (logdet, quad) equal slogdet and mᵀK⁻¹m; its K̄ rows and
m̄ for 3·logdet + ½·quad equal 3K⁻¹ − ½ααᵀ and αᵀ (α = K⁻¹m) and gpc_tpu's
custom VJP; and the same objective of θ through K(θ)'s rows (shared θ) has
gpc_tpu's value and θ̄ (θ̄ relative to its largest entry)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu.parallel.chol_distributed import chol_distributed as jax_chol
from gpc_tpu.parallel.chol_distributed import evidence_distributed as jax_evidence
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch import NoDeviceError

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import spawn_worlds  # noqa: E402

WORLDS = (1, 2, 3)
N = 48
TOL = 1e-10


def _inputs():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, N))
    X = rng.standard_normal((N, 3))
    return dict(K=A @ A.T + N * np.eye(N), m=rng.standard_normal((N, 3)), X=X,
                theta=np.array([0.7, 1.3, 0.3]))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_worlds("chol", _inputs(), WORLDS, tmp_path_factory)


@pytest.fixture(scope="module")
def references():
    a = _inputs()
    K, m, X = a["K"], a["m"], a["X"]
    mesh = jax_mesh()
    Ks = jax_shard_rows(mesh, K)
    ref = dict(L=np.asarray(jax_chol(mesh, Ks)))

    def ev(K_, m_):
        ld, quad = jax_evidence(mesh, K_, m_)
        return 3.0 * ld + 0.5 * quad
    ld, quad = jax_evidence(mesh, Ks, jnp.asarray(m))
    ref.update(logdet=float(ld), quad=float(quad))
    Kbar, mbar = jax.grad(ev, argnums=(0, 1))(Ks, jnp.asarray(m))
    ref.update(Kbar=np.asarray(Kbar), mbar=np.asarray(mbar))

    def obj(theta):
        iw, var, noise = theta
        d2 = jnp.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
        Kt = var * jnp.exp(-0.5 * iw * d2) + noise * jnp.eye(N)
        Kt = jax.device_put(Kt, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp", None)))
        return ev(Kt, jnp.asarray(m))
    f, g = jax.value_and_grad(obj)(jnp.asarray(a["theta"]))
    ref.update(theta_f=float(f), theta_g=np.asarray(g))
    return ref


@pytest.mark.parametrize("world", WORLDS)
def test_factor_matches_lapack_and_gpc_tpu(runs, references, world):
    a = _inputs()
    L = np.concatenate([r["L_rows"] for r in runs[world]])
    _close(L, np.linalg.cholesky(a["K"]))
    _close(L, references["L"])
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_evidence_and_its_cotangents(runs, references, world):
    a = _inputs()
    K, m = a["K"], a["m"]
    alpha = np.linalg.solve(K, m)
    Kbar = np.concatenate([r["Kbar_rows"] for r in runs[world]])
    for r in runs[world]:
        _close(r["logdet"], np.linalg.slogdet(K)[1])
        _close(r["logdet"], references["logdet"])
        _close(r["quad"], np.sum(m * alpha))
        _close(r["quad"], references["quad"])
        _close(r["mbar"], alpha)
        _close(r["mbar"], references["mbar"])
    _close(Kbar, 3.0 * np.linalg.inv(K) - 0.5 * alpha @ alpha.T)
    _close(Kbar, references["Kbar"])


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_through_the_gram_rows(runs, references, world):
    for r in runs[world]:
        _close(r["theta_f"], references["theta_f"])
        _close(r["theta_g"], references["theta_g"])


def test_entry_points_refuse_without_a_card(monkeypatch):
    """The distributed entry points run on the card unless asked for the
    CPU: without a card, a mesh on the default device raises."""
    import torch.distributed as dist

    from gpc_tpu_torch.parallel import mesh as TMESH
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "new_group", lambda ranks: None)
    with pytest.raises(NoDeviceError):
        TMESH.data_mesh()
    with pytest.raises(NoDeviceError):
        TMESH.mesh_2d(1, 1)
    m2 = TMESH.mesh_2d(1, 1, "cpu")
    assert (m2.mp.axis, m2.dp.axis, m2.mp.size, m2.dp.size) == ("mp", "dp", 1, 1)
    from gpc_tpu_torch.parallel.dist_sparse2d import replicated_2d, shard_data_2d
    a = np.arange(12.0).reshape(6, 2)
    assert np.array_equal(replicated_2d(m2, a).numpy(), a)
    assert np.array_equal(shard_data_2d(m2, a).numpy(), a)
    with pytest.raises(ValueError, match="world size"):
        TMESH.mesh_2d(2, 1, "cpu")
