"""The port's distributed GP-LVM / GPDM
(gpc_tpu_torch/parallel/dist_gplvm.py) on gloo at world sizes 1, 2 and 3
(tests/helpers/torch_dist2_worker.py, case "gplvm"), against gpc_tpu's
make_dist_gplvm_value_and_grad on its 8-virtual-device mesh and the port's
single-process GPLVM (carried over by interop.gplvm_from_jax), in float64.

The five cases of tests/test_dist_gplvm.py at N = 48: plain; dynamics with
a sequence break at 24; fixed-SNR dynamics (frozen dynamics kernel, D/q
scaling); back-constrained; back-constrained with dynamics.  On every rank,
to 1e-10 relative (θ̄: of its largest entry), the objective and θ̄, the N·q
latent gradients (or the back-constraint coefficients') included."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpc_tpu import kernels as GK
from gpc_tpu.models.gplvm import GPLVM as JGPLVM
from gpc_tpu.parallel.dist_gplvm import make_dist_gplvm_value_and_grad as jax_vag
from gpc_tpu.parallel.mesh import data_mesh as jax_mesh
from gpc_tpu.parallel.mesh import shard_rows as jax_shard_rows
from gpc_tpu_torch.interop.from_jax import gplvm_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import GPLVM_CASES, spawn_worlds  # noqa: E402

WORLDS = (1, 2, 3)
N = 48
TOL = 1e-10


def _jax_models():
    """{case: (gpc_tpu GPLVM, bK or None)}, as tests/test_dist_gplvm.py
    builds them."""
    q = 2

    def data(seed):
        return np.random.default_rng(seed).standard_normal((N, 3))

    def kern():
        return GK.Cmpnd(input_dim=q, components=(GK.Rbf(input_dim=q), GK.Bias(input_dim=q),
                                                 GK.White(input_dim=q)))

    def dyn():
        return GK.Cmpnd(input_dim=q, components=(GK.Rbf(input_dim=q), GK.White(input_dim=q)))

    def back(y):
        b = GK.Rbf(input_dim=y.shape[1])
        return np.asarray(b.gram(jnp.asarray(b.default_params()), jnp.asarray(y))) + 1e-4 * np.eye(N)

    y, y11 = data(4), data(11)
    return {
        "plain": (JGPLVM(kern(), y, latent_dim=q), None),
        "dynamics": (JGPLVM(kern(), y, latent_dim=q, dyn_kern=dyn(), dyn_breaks=(0, 24)), None),
        "fixed_snr": (JGPLVM(kern(), y, latent_dim=q, dyn_kern=dyn(), dyn_kern_learnt=False,
                             dyn_kern_params=np.array([1.0, 0.25, 0.01]),
                             dynamic_scaling=True), None),
        "back": (JGPLVM(kern(), y, latent_dim=q, back_kernel_matrix=back(y)), back(y)),
        "back_dynamics": (JGPLVM(kern(), y11, latent_dim=q, back_kernel_matrix=back(y11),
                                 dyn_kern=dyn()), back(y11)),
    }


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def models():
    return _jax_models()


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    inputs = {}
    for case, (jm, bK) in models.items():
        inputs.update({f"{case}_y": np.asarray(jm.y), f"{case}_theta": np.asarray(jm.theta),
                       f"{case}_bias": np.asarray(jm.noise_bias),
                       f"{case}_scales": np.asarray(jm.fixed_scales)})
        if bK is not None:
            inputs[f"{case}_bK"] = bK
    return spawn_worlds("gplvm", inputs, WORLDS, tmp_path_factory)


@pytest.fixture(scope="module")
def references(models):
    mesh = jax_mesh()
    ref = {}
    for case, (jm, bK) in models.items():
        vag = jax.jit(jax_vag(jm.spec, mesh, jm.noise_bias, jm.fixed_scales,
                              dyn_params_fixed=jm.dyn_params_fixed))
        args = (jm.theta, jax_shard_rows(mesh, jnp.asarray(jm.y)))
        if bK is not None:
            args += (jax_shard_rows(mesh, jnp.asarray(bK)),)
        f, g = vag(*args)
        port = gplvm_from_jax(jm, device="cpu")
        pf, pg = port.value_and_grad_fn()(port.theta)
        ref[case] = (float(f), np.asarray(g), pf, pg)
    return ref


@pytest.mark.parametrize("case", GPLVM_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_value_and_grad_match_single_process_and_gpc_tpu(runs, references, world, case):
    jf, jg, pf, pg = references[case]
    for r in runs[world]:
        _close(r[f"{case}_f"], pf)
        _close(r[f"{case}_f"], jf)
        _close(r[f"{case}_g"], pg)
        _close(r[f"{case}_g"], jg)
