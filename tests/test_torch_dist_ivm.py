"""The port's distributed IVM selection (gpc_tpu_torch/parallel/dist_ivm.py)
on gloo at world sizes 1, 2 and 3 (tests/helpers/torch_dist2_worker.py,
case "ivm"), against gpc_tpu's make_select_points_dist on its
8-virtual-device mesh and the port's single-process select_points, in
float64.

The cases of tests/test_dist_ivm.py: Gaussian and probit noise under
entropy, random and rentropy selection (N = 64, d = 16, draws from
default_rng(3)); a ragged N = 57 (d = 12), padded with invalid rows; the
probit training case.  On every rank: the selection order equals both
references' bit for bit, padding rows are never picked, the sites equal
the single process's within 1e-10 (relative to each field's largest
entry), the moments of the valid rows too, and the active-set likelihood
of the distributed selection equals both references' within 1e-10."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu.models.ivm import IvmSpec as JIvmSpec
from gpc_tpu.models.ivm import active_log_likelihood as jax_active_ll
from gpc_tpu.noise import GaussianNoise as JGaussian
from gpc_tpu.noise import ProbitNoise as JProbit
from gpc_tpu.parallel.dist_ivm import make_select_points_dist as jax_select
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import pad_rows as jax_pad_rows
from gpc_tpu.parallel.mesh import replicated as jax_replicated
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch.models.ivm import select_points

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import ivm_spec, spawn_worlds  # noqa: E402

WORLDS = (1, 2, 3)
TOL = 1e-10
SELECTION_CASES = [f"{n}_{s}" for n in ("gaussian", "probit")
                   for s in ("entropy", "random", "rentropy")]
CASES = SELECTION_CASES + ["ragged", "training"]


def _problem(N, noise_kind, seed):
    """tests/test_dist_ivm.py's data."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, 2))
    if noise_kind == "probit":
        y = np.sign(np.sin(2.0 * X[:, :1]) + 0.3 * rng.standard_normal((N, 1)))
    else:
        y = np.sin(2.0 * X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    return X, y


def _jax_spec(noise_kind, N, d, selection):
    kern = GK.Cmpnd(input_dim=2, components=(GK.Rbf(input_dim=2), GK.Bias(input_dim=2),
                                             GK.White(input_dim=2)))
    noise = JProbit(output_dim=1) if noise_kind == "probit" else JGaussian(output_dim=1)
    return JIvmSpec(kern=kern, noise=noise, n_data=N, input_dim=2, output_dim=1,
                    num_active=d, selection=selection)


def _inputs():
    cases = {}
    for tag in SELECTION_CASES:
        noise, sel = tag.split("_")
        cases[tag] = (noise, sel, 64, 16, 0, np.random.default_rng(3).random(16))
    cases["ragged"] = ("gaussian", "entropy", 57, 12, 5, np.zeros(12))
    cases["training"] = ("probit", "entropy", 64, 16, 9, np.zeros(16))
    a = dict(tags=np.array(CASES))
    for tag, (noise, sel, N, d, seed, rv) in cases.items():
        X, y = _problem(N, noise, seed)
        js = _jax_spec(noise, N, d, sel)
        a.update({f"{tag}_noise": np.array(noise), f"{tag}_selection": np.array(sel),
                  f"{tag}_X": X, f"{tag}_y": y, f"{tag}_d": np.array(d),
                  f"{tag}_kp": np.asarray(js.kern.default_params()),
                  f"{tag}_np": np.asarray(js.noise.default_params(y)), f"{tag}_rand": rv})
    return a


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return spawn_worlds("ivm", inputs, WORLDS, tmp_path_factory)


@pytest.fixture(scope="module")
def references(inputs):
    """{tag: (the port's single-process state, gpc_tpu's order, gpc_tpu's
    active-set likelihood of it)}."""
    a = inputs
    mesh = jax_mesh()
    nd = len(mesh.devices)
    ref = {}
    for tag in CASES:
        noise, sel = str(a[f"{tag}_noise"]), str(a[f"{tag}_selection"])
        X, y, d = a[f"{tag}_X"], a[f"{tag}_y"], int(a[f"{tag}_d"])
        N = X.shape[0]
        kp, npar, rv = a[f"{tag}_kp"], a[f"{tag}_np"], a[f"{tag}_rand"]
        single = select_points(ivm_spec(noise, N, d, sel), torch.as_tensor(kp),
                               torch.as_tensor(npar), torch.as_tensor(X), torch.as_tensor(y), rv)
        js = _jax_spec(noise, N, d, sel)
        Xp, _ = jax_pad_rows(X, nd)
        yp, _ = jax_pad_rows(y, nd)
        valid = np.zeros(Xp.shape[0])
        valid[:N] = 1.0
        st = jax.jit(jax_select(js, mesh))(
            jnp.asarray(kp), jnp.asarray(npar), *(jax_shard_rows(mesh, v) for v in (Xp, yp, valid)),
            jax_replicated(mesh, rv))
        order = np.asarray(st.active_idx)
        ll = float(jax_active_ll(js, jnp.asarray(kp), jnp.asarray(X[order]), st.m_site,
                                 st.beta_site))
        ref[tag] = (single, order, ll)
    return ref


@pytest.mark.parametrize("tag", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_selection_order_and_state_match(runs, references, inputs, world, tag):
    single, jax_order, _ = references[tag]
    N = inputs[f"{tag}_X"].shape[0]
    want = single.active_idx.numpy()
    np.testing.assert_array_equal(jax_order, want)
    for r in runs[world]:
        np.testing.assert_array_equal(r[f"{tag}_active_idx"], want)
        assert np.all(r[f"{tag}_active_idx"] < N)
        _close(r[f"{tag}_m_site"], single.m_site.numpy())
        _close(r[f"{tag}_beta_site"], single.beta_site.numpy())
    for field, full in (("mu", single.mu), ("varsigma", single.varsigma)):
        _close(np.concatenate([r[f"{tag}_{field}"] for r in runs[world]])[:N], full.numpy())
    mask = np.concatenate([r[f"{tag}_active_mask"] for r in runs[world]])
    np.testing.assert_array_equal(np.flatnonzero(mask), np.sort(want))


@pytest.mark.parametrize("world", WORLDS)
def test_training_after_distributed_selection(runs, references, inputs, world):
    from gpc_tpu_torch.models.ivm import active_log_likelihood
    tag = "training"
    single, _, jax_ll = references[tag]
    X = inputs[f"{tag}_X"]
    spec = ivm_spec("probit", X.shape[0], 16, "entropy")
    ll = float(active_log_likelihood(spec, torch.as_tensor(inputs[f"{tag}_kp"]),
                                     torch.as_tensor(X[single.active_idx.numpy()]),
                                     single.m_site, single.beta_site))
    for r in runs[world]:
        _close(r[f"{tag}_ll"], ll)
        _close(r[f"{tag}_ll"], jax_ll)
