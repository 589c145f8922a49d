"""Carry a gpc_tpu model's parameters into the port.

`from_jax(kern_desc, theta, X, y, bias, fixed_scales)` rebuilds a
gpc_tpu_torch FTC `GP` from gpc_tpu's pieces as numpy arrays.  The
unconstrained theta layout is shared (gpc_tpu/models/gp.py:11-15), so this
is a structural map of the kernel tree: `kern_desc` is a gpc_tpu kernel
object, read only through its attributes (kind, input_dim, components,
fixed_variance, degree, priors), so this module imports neither jax nor
gpc_tpu.
"""

from __future__ import annotations

import numpy as np

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch.models.gp import GP
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
             learn_scales: bool = False, device=None) -> GP:
    """A port GP holding gpc_tpu's FTC parameters and data, on `device`
    (None: the card, and an error without one; "cpu" for the CPU)."""
    kern = kern_from_desc(kern_desc)
    model = GP(kern, X, y, learn_scales=learn_scales, centre=False,
               device=device)
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    if theta.shape[0] != model.spec.n_params():
        raise ValueError(f"theta has {theta.shape[0]} entries, the FTC model "
                         f"{model.spec.n_params()}")
    model.theta = theta.copy()
    model.bias = np.asarray(bias, dtype=np.float64).reshape(-1)
    model.fixed_scales = np.asarray(fixed_scales, dtype=np.float64).reshape(-1)
    return model
