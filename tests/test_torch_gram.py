"""K1 (gpc_tpu_torch/ops/gram.py) against gpc_tpu's fused Gram tiles.

The port's plain version runs on the CPU; the Pallas tile kernel runs in
interpret mode.  Both compute in float32 from the same numpy inputs, so
they differ only in summation order: rtol/atol 2e-5, as
tests/test_gram_pallas.py holds the Pallas kernel to its jnp fallback.
The CUDA kernel is compared with the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.ops.gram_pallas import dist_gram as jax_dist_gram
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.ops import gram as TG

PARAMS = {"rbf": [0.7, 1.3], "exp": [0.7, 1.3], "ratquad": [1.5, 0.8, 1.3],
          "matern32": [0.9, 1.3], "matern52": [0.9, 1.3]}


@pytest.mark.parametrize("family", TG.FAMILIES)
def test_plain_matches_pallas_interpret(family):
    rng = np.random.default_rng(11)
    X1 = rng.standard_normal((256, 4)).astype(np.float32)
    X2 = rng.standard_normal((256, 4)).astype(np.float32)
    p = np.asarray(PARAMS[family], np.float32)
    want = np.asarray(jax_dist_gram(family, jnp.asarray(p), jnp.asarray(X1),
                                    jnp.asarray(X2), tile=128, interpret=True))
    got = TG.dist_gram(family, torch.from_numpy(p), torch.from_numpy(X1),
                       torch.from_numpy(X2))
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ragged_rbf_matches_kernels_compute():
    """Ragged 100×70 in float64: the port's Rbf.compute (K1's plain version
    on the CPU) against gpc_tpu's Rbf.compute."""
    rng = np.random.default_rng(12)
    X1 = rng.standard_normal((100, 3))
    X2 = rng.standard_normal((70, 3))
    p = np.array([0.8, 1.7])
    want = np.asarray(GK.Rbf(input_dim=3).compute(jnp.asarray(p), jnp.asarray(X1),
                                                  jnp.asarray(X2)))
    got = TK.Rbf(input_dim=3).compute(torch.from_numpy(p), torch.from_numpy(X1),
                                      torch.from_numpy(X2))
    assert got.shape == (100, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_unknown_family_raises():
    X = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="unknown distance family"):
        TG.dist_gram("lin", [1.0], X, X)
