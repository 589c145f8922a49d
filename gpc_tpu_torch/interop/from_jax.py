"""Carry a gpc_tpu model's parameters into the port.

`gplvm_from_jax(model)` rebuilds a port `GPLVM` from a gpc_tpu GPLVM read
through its attributes: θ, the spec's flags (latent dimension, dynamics
and whether they are learnt, back constraints, learn_scales,
regularisation, dynamic scaling, sequence breaks), the kernel and dynamics
kernel, bK, the bias and the scales, all as numpy.

`ivm_from_jax(kern_desc, noise_desc, X, y, num_active, ...)` rebuilds a
port `IVM` the same way: the kernel and the noise model (its kind and
extras: output_dim, split_gamma, num_categories, width, sigma2) read through
their attributes, the parameters, the data and, optionally, the active set
and its sites.

`from_jax(kern_desc, theta, X, y, bias, fixed_scales, ...)` rebuilds a
gpc_tpu_torch `GP` from gpc_tpu's pieces as numpy arrays, FTC or sparse
(the approximation, the active-set size, PITC's block size and the fixed
inducing inputs, if any, as keywords).  The unconstrained theta layout is shared
(gpc_tpu/models/gp.py:11-15: X_u column-major, the kernel, the scales,
log β), so this is a structural map of the kernel tree: `kern_desc` is a
gpc_tpu kernel object, read only through its attributes (kind, input_dim,
components, fixed_variance, degree, priors), so this module imports neither
jax nor gpc_tpu.
"""

from __future__ import annotations

import numpy as np

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch import noise as NZ
from gpc_tpu_torch.models.gp import FTC, GP
from gpc_tpu_torch.models.gplvm import GPLVM
from gpc_tpu_torch.models.ivm import ENTROPY, IVM, restored_state
from gpc_tpu_torch.priors import Prior


def kern_from_desc(desc) -> KM.Kern:
    """The port's kernel tree for a gpc_tpu kernel object."""
    priors = tuple(Prior(p.kind, tuple(float(h) for h in p.hyp), int(p.index))
                   for p in getattr(desc, "priors", ()))
    if desc.kind in ("cmpnd", "tensor"):
        children = tuple(kern_from_desc(c) for c in desc.components)
        return KM.make_kern(desc.kind, desc.input_dim,
                            components=children).with_priors(priors)
    if desc.kind == "whitefixed":
        return KM.WhiteFixed(input_dim=desc.input_dim,
                             fixed_variance=float(desc.fixed_variance),
                             priors=priors)
    kwargs = {}
    if desc.kind in ("poly", "polyard"):
        kwargs["degree"] = float(desc.degree)
    return KM.make_kern(desc.kind, desc.input_dim, **kwargs).with_priors(priors)


def from_jax(kern_desc, theta, X, y, bias, fixed_scales,
             learn_scales: bool = False, approx: str = FTC, num_active: int = 0,
             pitc_block: int = 0, inducing_fixed: bool = False, X_u_fixed=None,
             device=None) -> GP:
    """A port GP holding gpc_tpu's parameters and data, on `device` (None:
    the card, and an error without one; "cpu" for the CPU)."""
    kern = kern_from_desc(kern_desc)
    model = GP(kern, X, y, approx=approx, num_active=num_active,
               learn_scales=learn_scales, centre=False, inducing_fixed=inducing_fixed,
               pitc_block=pitc_block, device=device)
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    if theta.shape[0] != model.spec.n_params():
        raise ValueError(f"theta has {theta.shape[0]} entries, the {approx} model "
                         f"{model.spec.n_params()}")
    if inducing_fixed:
        if X_u_fixed is None:
            raise ValueError("inducing_fixed needs X_u_fixed")
        model.X_u_fixed = np.asarray(X_u_fixed, dtype=np.float64)
    model.theta = theta.copy()
    model.bias = np.asarray(bias, dtype=np.float64).reshape(-1)
    model.fixed_scales = np.asarray(fixed_scales, dtype=np.float64).reshape(-1)
    return model


def noise_from_desc(desc) -> NZ.Noise:
    """The port's noise model for a gpc_tpu noise object."""
    kwargs = {}
    for name in ("split_gamma", "width", "sigma2", "num_categories"):
        if hasattr(desc, name):
            kwargs[name] = getattr(desc, name)
    return NZ.make_noise(desc.kind, int(desc.output_dim), **kwargs)


def ivm_from_jax(kern_desc, noise_desc, X, y, num_active: int, kern_params, noise_params,
                 selection: str = ENTROPY, seed=None, active_idx=None, m_site=None,
                 beta_site=None, device=None) -> IVM:
    """A port IVM holding gpc_tpu's kernel, noise model, parameters and data
    (numpy), and, when active_idx, m_site and beta_site are given, its
    active set and sites; on `device` (None: the card; "cpu" for the CPU)."""
    model = IVM(kern_from_desc(kern_desc), noise_from_desc(noise_desc), X, y,
                num_active=num_active, selection=selection, seed=seed,
                kern_params=np.asarray(kern_params, dtype=np.float64),
                noise_params=np.asarray(noise_params, dtype=np.float64), device=device)
    if active_idx is not None:
        model.state = restored_state(model, active_idx, m_site, beta_site)
    return model


def gplvm_from_jax(model, device=None) -> GPLVM:
    """A port GPLVM holding a gpc_tpu GPLVM's θ, flags, kernels, bK and
    preprocessing, on `device` (None: the card; "cpu" for the CPU)."""
    spec = model.spec
    y = np.asarray(model.y, dtype=np.float64)
    bK = None if model.bK is None else np.asarray(model.bK, dtype=np.float64)
    dyn = None if spec.dyn_kern is None else kern_from_desc(spec.dyn_kern)
    dpf = None if model.dyn_params_fixed is None else np.asarray(model.dyn_params_fixed,
                                                                 dtype=np.float64)
    out = GPLVM(kern_from_desc(spec.kern), y, latent_dim=spec.latent_dim, dyn_kern=dyn,
                dyn_kern_params=dpf, dyn_kern_learnt=spec.dyn_kern_learnt,
                back_kernel_matrix=bK, centre=False, learn_scales=spec.learn_scales,
                latent_regularised=spec.latent_regularised,
                dynamic_scaling=float(spec.dynamic_scaling) != 1.0,
                dyn_breaks=spec.dyn_breaks, init="rand", device=device)
    theta = np.asarray(model.theta, dtype=np.float64).reshape(-1)
    if theta.shape[0] != out.spec.n_params():
        raise ValueError(f"theta has {theta.shape[0]} entries, the model "
                         f"{out.spec.n_params()}")
    out.theta = theta.copy()
    out.noise_bias = np.asarray(model.noise_bias, dtype=np.float64).reshape(-1)
    out.fixed_scales = np.asarray(model.fixed_scales, dtype=np.float64).reshape(-1)
    return out
