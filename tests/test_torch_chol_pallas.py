"""K5 and K6 (gpc_tpu_torch/ops/chol_pallas.py) against gpc_tpu's
chol_pallas kernels in interpret mode, on the CPU.

  * chol_block's plain version (torch.linalg.cholesky) against gpc_tpu's
    `chol_block(interpret=True)`, the masked column sweep, at n = 96, 157,
    192 and 256; float64, whose sweep computes in the input's dtype: 1e-9 of
    the largest entry.
  * chol_inv_block at ragged n against gpc_tpu's masked sweep and
    forward-substitution inverse (chol_pallas.py:185) is in
    tests/test_torch_chol_panel.py, beside its whole-block cases.
  * evidence_left_fast with the default Policy's fields (base 256, K5
    leaves) at N = 625, where the halving gives leaves of 156 and 157, with
    bf16=False on both sides: float64, 1e-8 relative on logdet and quad.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu.ops import chol_pallas as JCPL
from gpc_tpu.ops import evidence_fast as JEF
from gpc_tpu.ops import lazy_evidence as JLE
from gpc_tpu_torch.interop.from_jax import kern_from_desc
from gpc_tpu_torch.ops import chol_pallas as TCPL
from gpc_tpu_torch.ops import chol_panel as TCP
from gpc_tpu_torch.ops import evidence_fast as TEF
from gpc_tpu_torch.ops import lazy_evidence as TLE


def _spd(n, seed):
    Z = np.random.default_rng(seed).standard_normal((n, n))
    return Z @ Z.T + n * np.eye(n)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n", [96, 157, 192, 256])
def test_chol_block_plain_matches_pallas_interpret(n):
    A = _spd(n, n)
    L_want = JCPL.chol_block(jnp.asarray(A), interpret=True)
    L = TCPL.chol_block(torch.from_numpy(A))
    assert L.dtype == torch.float64 and L.shape == (n, n)
    _close(L.numpy(), L_want, 1e-9)
    assert not bool(torch.triu(L, 1).any())
    # K5 lives beside K6 and keeps its old import path
    assert TCP.chol_inv_block is TCPL.chol_inv_block


def test_evidence_left_fast_ragged_leaves_match_jax():
    """N = 625 halves to 312/313, then to leaves of 156 and 157: every leaf
    takes K5's ragged branch (chol_pallas.py:185 in gpc_tpu)."""
    Q = 3
    jk = GK.Cmpnd(input_dim=Q, components=(GK.Mlp(input_dim=Q), GK.White(input_dim=Q)))
    tk = kern_from_desc(jk)
    rng = np.random.default_rng(11)
    X, m = rng.standard_normal((625, Q)), rng.standard_normal((625, 2))
    p = jk.default_params()
    p[-1] = 0.3
    pol = dict(base=256, bf16=False, leafinv="pallas", stack=True)
    ld_j, q_j = JEF.evidence_left_fast(JLE.kern_block_fn(jk, jnp.asarray(p), jnp.asarray(X)),
                                       625, jnp.asarray(m), JEF.Policy(**pol))
    ld_t, q_t = TEF.evidence_left_fast(TLE.kern_block_fn(tk, torch.from_numpy(p),
                                                         torch.from_numpy(X)),
                                       625, torch.from_numpy(m), TEF.Policy(**pol))
    assert TEF.Policy(**pol) == TEF.Policy()
    assert ld_t.dtype == torch.float64
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-8)
    np.testing.assert_allclose(float(q_t), float(q_j), rtol=1e-8)
