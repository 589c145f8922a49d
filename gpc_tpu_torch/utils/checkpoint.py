"""Training checkpoints: the parameter vector and the optimiser state.

Counterpart of gpc_tpu/utils/checkpoint.py without JAX: the same npz keys
(`step`, `theta`, `extra_<name>`, and `prng_key` where gpc_tpu stored one)
and the same atomic write (tmp + rename), so a killed run never leaves a
torn file and each package reads the other's checkpoints.  The port's SCG
path has no PRNG key to store; `load` hands back a stored key's raw data.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def save(path: str, step: int, theta, extra: dict | None = None):
    """Atomically write a checkpoint."""
    payload = {"step": np.asarray(step), "theta": np.asarray(theta)}
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str):
    """Returns (step, theta, extra, prng_key_data or None)."""
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        theta = z["theta"]
        prng_key = z["prng_key"] if "prng_key" in z else None
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return step, theta, extra, prng_key
