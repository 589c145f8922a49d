"""The GP-LVM / GPDM objective with the latent rows sharded with the
evidence (counterpart of gpc_tpu/parallel/dist_gplvm.py).

The latent coordinates live in the replicated θ (CGplvm's layout,
CGplvm.cpp:257-330).  Each rank builds the Gram rows of its slice of latent
points (a K1/K4 launch against all of X), and the row-sharded evidence runs
through chol_distributed.evidence_distributed, so one torch.autograd.grad
gives ∂NLML/∂θ, the N·q latent gradients included, with no N × N object on
any rank.

  * Dynamics (CGplvm.cpp:448-489): a second row-sharded evidence over the
    same latent rows, the sequence-break rows and columns knocked out to the
    identity on each shard, with the up-shifted Xout (break rows zeroed,
    CGplvm.cpp:231-243) as its replicated right-hand side.
  * Back constraints X = bK·A (CGplvm.cpp:683-701): bK is row-sharded with
    the data; each rank computes its rows of X with one local GEMM and X is
    one all-gather; the chain rule to A runs back through both.

gpc_tpu's quirks are kept: no 2π term, and with dynamics only X[:, 0] is
regularised.  There is no jitter rescue (chol_distributed.py).  N must
divide by the world size.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import as_tensor
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gplvm import GplvmSpec, _xout
from gpc_tpu_torch.parallel.chol_distributed import evidence_distributed
from gpc_tpu_torch.parallel.dist_gp import all_gather_rows, share
from gpc_tpu_torch.parallel.mesh import Mesh


def _gram_rows(kern, p, X_l, X, rows):
    """This rank's rows of kern.gram(p, X): the cross compute with the
    diagonal overwritten by diag(p, X_l), as gram() does."""
    own = (torch.arange(X_l.shape[0], device=X.device), rows)
    return kern.compute(p, X_l, X).index_put(own, kern.diag(p, X_l))


def make_dist_gplvm_value_and_grad(spec: GplvmSpec, mesh: Mesh, noise_bias, fixed_scales,
                                   dyn_params_fixed=None):
    """nlml(theta, y[, bK]) — the distributed CGplvm::logLikelihood
    (CGplvm.cpp:493-716), negated: theta replicated on the mesh's device, y
    this rank's (N/world, D) rows and, when spec.back_constrained, bK this
    rank's (N/world, N) rows of the back-constraint kernel matrix.  Returns
    the replicated 0-d objective, differentiable in theta (gpc_tpu returns
    jax.value_and_grad of it; the port keeps dist_gp's convention).
    `dyn_params_fixed` is needed when spec.has_dynamics and not
    spec.dyn_kern_learnt."""
    N, D, q = spec.n_data, spec.data_dim, spec.latent_dim
    if N % mesh.size:
        raise ValueError(f"make_dist_gplvm_value_and_grad: N = {N} does not divide by "
                         f"the world size {mesh.size}")
    B = N // mesh.size
    dev = mesh.device
    noise_bias = as_tensor(np.asarray(noise_bias, dtype=np.float64), dev)
    fixed_scales = as_tensor(np.asarray(fixed_scales, dtype=np.float64), dev)
    dpf = (as_tensor(np.asarray(dyn_params_fixed, dtype=np.float64), dev)
           if dyn_params_fixed is not None else None)
    rows = mesh.rank * B + torch.arange(B, device=dev)
    if spec.has_dynamics:
        keep = torch.ones(N, dtype=noise_bias.dtype, device=dev).index_fill(
            0, torch.as_tensor(spec.break_rows(), device=dev), 0.0)
        keep_l = keep[rows]

    def nlml(theta, yl, bKl=None):
        kp_l, dp_l, Xvals_l, scales_l = spec.unpack(share(theta, mesh))
        kp, dp, Xvals, scales = spec.unpack(theta)
        scales = scales if spec.learn_scales else fixed_scales
        scales_l = scales_l if spec.learn_scales else fixed_scales
        if spec.back_constrained:
            # X = bK·A: this rank's rows by one local GEMM, X by one all-gather
            X_l = bKl @ Xvals_l
            X = all_gather_rows(X_l, mesh)        # replicated
            X_sh = share(X, mesh)                 # ... entering this rank's rows
        else:
            X, X_sh = Xvals, Xvals_l
            X_l = Xvals_l[mesh.rank * B:(mesh.rank + 1) * B]
        K_rows = _gram_rows(spec.kern, kp_l, X_l, X_sh, rows)
        m = all_gather_rows((yl - noise_bias[None, :]) / scales_l[None, :], mesh)
        logdet, quad = evidence_distributed(mesh, K_rows, m)
        Lacc = quad + D * logdet
        if spec.has_dynamics:
            dpl = dp_l if dp_l is not None else dpf
            K2 = _gram_rows(spec.dyn_kern, dpl, X_l, X_sh, rows)
            # break rows and columns to the identity (CGplvm.cpp:448-477)
            K2 = (K2 * keep_l[:, None] * keep[None, :]).index_put(
                (torch.arange(B, device=dev), rows), torch.where(
                    keep_l > 0, K2[torch.arange(B, device=dev), rows], torch.ones_like(keep_l)))
            ld2, quad2 = evidence_distributed(mesh, K2, _xout(spec, X))
            Lacc = Lacc + spec.dynamic_scaling * (quad2 + q * ld2)
            if spec.latent_regularised:
                # dynamics regularise column 0 only (CGplvm.cpp:530-534)
                Lacc = Lacc + torch.sum(X[:, 0] ** 2)
        elif spec.latent_regularised:
            Lacc = Lacc + torch.sum(X * X)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * torch.sum(torch.log(torch.abs(scales)))
        L = -0.5 * Lacc + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        if spec.has_dynamics and spec.dyn_kern_learnt:
            L = L + priors_mod.total_log_prob(spec.dyn_kern.priors_global, dp)
        # no 2π term: CGplvm's quirk, as models/gplvm.py
        return -L

    return nlml


def _check_case(mesh: Mesh, n_devices: int, model, tag: str, rtol=2e-3, atol=5e-4):
    """The distributed value and θ̄ of `model` against the single process's
    log_likelihood on the same device (gpc_tpu's smoke tolerances, which
    cover float32 reduction order; the CPU tests hold float64 to 1e-10)."""
    from gpc_tpu_torch.models.gplvm import log_likelihood
    from gpc_tpu_torch.parallel.mesh import shard_rows

    dev = mesh.device
    nb, fs = (as_tensor(a, dev) for a in (model.noise_bias, model.fixed_scales))
    dpf = as_tensor(model.dyn_params_fixed, dev) if model.dyn_params_fixed is not None else None
    nlml = make_dist_gplvm_value_and_grad(model.spec, mesh, model.noise_bias, model.fixed_scales,
                                          dyn_params_fixed=model.dyn_params_fixed)
    args = [shard_rows(mesh, model.y)]
    if model.bK is not None:
        args.append(shard_rows(mesh, model.bK))

    def value_and_grad(f):
        t = as_tensor(model.theta, dev).requires_grad_(True)
        v = f(t)
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g.cpu().numpy()

    val, grad = value_and_grad(lambda t: nlml(t, *args))
    want, g_single = value_and_grad(lambda t: -log_likelihood(
        model.spec, t, model.yd, nb, fs, dyn_params_fixed=dpf, bK=model.bKd))
    if abs(val - want) / max(abs(want), 1.0) >= 1e-4:
        raise AssertionError(f"dist_gplvm dryrun [{tag}]: value {val}, single process {want}")
    np.testing.assert_allclose(grad, g_single, rtol=rtol, atol=atol, err_msg=tag)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): OK — distributed GP-LVM [{tag}] "
              f"value+grad {val:.6f} matches single-chip {want:.6f}")


def dryrun(mesh: Mesh, n_devices: int) -> None:
    """The distributed GP-LVM value and gradient on tiny shapes (N = 8 a
    rank) against the single process on `mesh`: plain, GPDM dynamics and
    back-constrained.  Raises on a mismatch."""
    from gpc_tpu_torch import kernels as K
    from gpc_tpu_torch.models.gplvm import GPLVM

    N, D, q = 8 * n_devices, 3, 2
    y = np.random.default_rng(4).standard_normal((N, D))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    dev = mesh.device
    _check_case(mesh, n_devices, GPLVM(kern, y, latent_dim=q, device=dev), "plain")

    dyn = K.Cmpnd(input_dim=q, components=(K.Rbf(input_dim=q), K.White(input_dim=q)))
    model_dyn = GPLVM(kern, y, latent_dim=q, dyn_kern=dyn, dyn_breaks=(0, N // 2), device=dev)
    _check_case(mesh, n_devices, model_dyn, "dynamics")

    back = K.Rbf(input_dim=D)
    yd = torch.as_tensor(y)
    bK = back.gram(torch.as_tensor(back.default_params()), yd).numpy() + 1e-4 * np.eye(N)
    model_bc = GPLVM(kern, y, latent_dim=q, back_kernel_matrix=bK, device=dev)
    _check_case(mesh, n_devices, model_bc, "back-constrained")
