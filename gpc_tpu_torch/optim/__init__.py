"""Optimisers: SCG (the default), CG, GD, L-BFGS (native) and checkgrad.

Dispatch mirrors the reference optimiser names scg|conjgrad|graddesc|quasinew
(COptimisable.h:153-182), as gpc_tpu/optim/__init__.py does.  Mid-run
checkpoints are SCG's only.
"""

from __future__ import annotations

import os
from typing import NamedTuple

from gpc_tpu_torch.optim.cg import CgResult, cg  # noqa: F401
from gpc_tpu_torch.optim.checkgrad import check_gradients  # noqa: F401
from gpc_tpu_torch.optim.gd import GdResult, gd, gd_pullback  # noqa: F401
from gpc_tpu_torch.optim.lbfgs import LbfgsResult, lbfgs  # noqa: F401
from gpc_tpu_torch.optim.scg import ScgResult, scg, scg_checkpointed, scg_minimize  # noqa: F401

OPTIMISERS = ("scg", "conjgrad", "graddesc", "quasinew")


def numpy_value_and_grad(nlml, device):
    """The optimisers' interface to a model's objective: w (float64 numpy)
    → (nlml(w), ∇nlml(w)) as float64, evaluated on `device` in its working
    dtype under autograd; a gradient the objective does not reach is zero."""
    import numpy as np
    import torch

    from gpc_tpu_torch import as_tensor

    def vag(w):
        theta = as_tensor(np.array(w, dtype=np.float64), device).requires_grad_(True)
        f = nlml(theta)
        g = None
        if f.requires_grad:
            (g,) = torch.autograd.grad(f, theta, allow_unused=True)
        g = torch.zeros_like(theta) if g is None else g
        return float(f.detach()), g.detach().cpu().numpy().astype(np.float64)
    return vag


class OptResult(NamedTuple):
    x: object
    obj: object
    iters: object


def run_optimiser(name: str, value_and_grad_fn, x0, max_iters: int,
                  param_tol: float = 1e-6, obj_tol: float = 1e-6,
                  ckpt_path: str = None, ckpt_every: int = 50,
                  resume: bool = False) -> OptResult:
    """Run the named optimiser; returns a uniform (x, obj, iters) result.

    `ckpt_path` enables mid-run checkpoints (SCG only): the full optimiser
    state is written atomically every `ckpt_every` iterations through
    utils/checkpoint, and `resume=True` continues a killed run from the file
    on the identical trajectory."""
    if name == "conjgrad":
        r = cg(value_and_grad_fn, x0, max_iters=max_iters)
        return OptResult(r.x, r.obj, r.iters)
    if name == "graddesc":
        r = gd(value_and_grad_fn, x0, max_iters=max_iters,
               param_tol=param_tol, obj_tol=obj_tol)
        return OptResult(r.x, r.obj, r.iters)
    if name == "quasinew":
        r = lbfgs(value_and_grad_fn, x0, max_iters=max_iters)
        return OptResult(r.x, r.obj, r.iters)
    if name != "scg":
        raise ValueError(f"Unrecognised optimiser type: {name}")
    if not ckpt_path:
        r = scg(value_and_grad_fn, x0, max_iters=max_iters,
                param_tol=param_tol, obj_tol=obj_tol)
        return OptResult(r.x, r.obj, r.iters)
    from gpc_tpu_torch.utils import checkpoint as ckpt

    resume_state = None
    if resume and os.path.exists(ckpt_path):
        _step, theta, extra, _key = ckpt.load(ckpt_path)
        resume_state = dict(extra, w=theta)

    def on_checkpoint(step, state):
        st = dict(state)
        ckpt.save(ckpt_path, step, st.pop("w"), extra=st)

    r = scg_checkpointed(value_and_grad_fn, x0, max_iters=max_iters,
                         param_tol=param_tol, obj_tol=obj_tol,
                         ckpt_every=ckpt_every, on_checkpoint=on_checkpoint,
                         resume_state=resume_state)
    return OptResult(r.x, r.obj, r.iters)
