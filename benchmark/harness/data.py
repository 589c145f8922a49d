"""Inputs made from a run's seed.  Every stream of random numbers (the
training data, the traffic, the requests' inputs, the sample that the
reference checks) comes from its own numpy Generator keyed by (seed,
stream), so the same seed gives the same inputs and the streams do not
depend on one another."""

from __future__ import annotations

import numpy as np

DATA, TRAFFIC, INPUTS, SAMPLE = 0, 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    """The Generator of `stream` under `seed` (any whole number; negative
    and wider-than-64-bit seeds are reduced modulo 2**64)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def regression(seed: int, n: int, q: int, d: int, noise: float):
    """The slice's regression data (chip_smoke.slice_data, bench.py:33-40):
    X ~ N(0, 1)^(n×q), y = sin(ΣX) + noise·ε in each of d columns, float64."""
    g = rng(seed, DATA)
    X = g.standard_normal((n, q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + noise * g.standard_normal((n, d))
    return X, y
