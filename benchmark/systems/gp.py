"""The system under test for a `gp` configuration: the port's GP
regression model (gpc_tpu_torch.models.gp), its optimiser entry and its
batch prediction server.  This file and the drivers are all that the
benchmark imports of the program."""

from __future__ import annotations

import os

import numpy as np


def configure(cfg: dict) -> None:
    """The environment the configuration states for the program: the FTC
    evidence engine (GPC_TPU_EVIDENCE), read by the program at each call."""
    if cfg["approx"] == "ftc":
        os.environ["GPC_TPU_EVIDENCE"] = cfg["evidence"]


def kernel(cfg: dict):
    """The CLI's kernel, cmpnd(rbf, bias, white) at its defaults."""
    from gpc_tpu_torch import kernels as KM

    if cfg["kernel"] != ["rbf", "bias", "white"]:
        raise ValueError(f"gp system: kernel {cfg['kernel']} is not the CLI's default")
    q = cfg["q"]
    return KM.Cmpnd(input_dim=q, components=(KM.Rbf(input_dim=q), KM.Bias(input_dim=q),
                                             KM.White(input_dim=q)))


def model(cfg: dict, X: np.ndarray, y: np.ndarray, seed: int, device: str):
    """GP(kern, X, y) as `gp learn` builds it: centred data, unit scales,
    β = 1 and, for a sparse model, the M inducing inputs of the seeded
    subset of X that GP takes (`-s seed`, reduced to 32 bits as the
    reference's MT19937 seeding reduces it)."""
    from gpc_tpu_torch.models.gp import GP

    sparse = cfg["approx"] != "ftc"
    return GP(kernel(cfg), X, y, approx=cfg["approx"], num_active=cfg["M"] if sparse else 0,
              beta=1.0, seed=int(seed) % 2 ** 32 if sparse else None, device=device)


def optimise(value_and_grad, theta0: np.ndarray, iters: int):
    """One training segment: the call GP.optimise(iters=...) makes."""
    from gpc_tpu_torch.optim import run_optimiser

    return run_optimiser("scg", value_and_grad, theta0, iters)


def server(cfg: dict, gp):
    """GPServer(model) with the configuration's chunk and its explicit
    inverse (FTC; a sparse model keeps its M × M factors)."""
    from gpc_tpu_torch.serving import GPServer

    return GPServer(gp, chunk=cfg["chunk"], explicit_inverse=cfg["approx"] == "ftc")
