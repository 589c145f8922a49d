"""Interoperation: gpc_tpu's objects (from_jax) and the fGP mex API (fgp)."""

from gpc_tpu_torch.interop.fgp import clear, fgp, query, retrain, train  # noqa: F401
