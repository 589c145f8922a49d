"""K2 and K3 (gpc_tpu_torch/ops/chol_panel.py) against gpc_tpu's Pallas
panel kernel and its leaf.

K2: the plain (Cholesky + triangular inverse) version against
`_factor_diag_fast`, float32, 1e-4 relative on the logdet and 1e-4·‖M‖ on
M.  K3: the plain version against `panel_state_rbf(..., interpret=True)` at
N = 1536, b = 128, D = 2, 2e-3 relative on the logdet and diag(G) — the
bound the bf16 L buffer of the Pallas kernel is held to
(tests/test_chol_panel.py).  K3 mode "full+diag": T's diagonal blocks
against the Pallas kernel's at N = 512, and T's layout in both modes.  K5:
the plain (L, L⁻¹) against `chol_pallas.chol_inv_block(interpret=True)`.
The CUDA kernels are compared with the plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu.ops import chol_panel as JCP
from gpc_tpu_torch.ops import chol_panel as TCP
from gpc_tpu_torch.ops import gram as TG


def _pd_blocks(rng, batch, b):
    Z = rng.standard_normal((batch, b, b)).astype(np.float32)
    return (Z @ np.swapaxes(Z, 1, 2) / b + 0.5 * np.eye(b, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("b", [128, 256])
def test_factor_diag_plain_matches_leaf(b):
    A = _pd_blocks(np.random.default_rng(b), 1, b)[0]
    M_want, ld_want = JCP._factor_diag_fast(jnp.asarray(A), b)
    M, ld = TCP.factor_diag(torch.from_numpy(A)[None])
    M_want = np.asarray(M_want)
    assert abs(float(ld[0]) - float(ld_want)) <= 1e-4 * abs(float(ld_want))
    assert np.linalg.norm(M[0].numpy() - M_want) <= 1e-4 * np.linalg.norm(M_want)


def test_panel_state_plain_matches_pallas_interpret():
    N, q, D = 1536, 8, 2
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, q)).astype(np.float32)
    m = rng.standard_normal((N, D)).astype(np.float32)
    ld_want, G_want, _v, _T = JCP.panel_state_rbf(
        jnp.asarray(X), jnp.asarray(m), jnp.float32(1.0), jnp.float32(1.0),
        jnp.float32(0.1), b=128, interpret=True)
    ld, G, v, T = TCP.panel_state_rbf(torch.tensor(X, dtype=torch.float64),
                                      torch.tensor(m, dtype=torch.float64),
                                      1.0, 1.0, 0.1, b=128)
    assert v.shape == (D, N) and T.shape == (N, N) and T.dtype == torch.bfloat16
    assert abs(float(ld) - float(ld_want)) <= 2e-3 * abs(float(ld_want))
    g, g_want = np.diagonal(G.numpy()), np.diagonal(np.asarray(G_want))
    assert np.all(np.abs(g - g_want) <= 2e-3 * np.abs(g_want))


def test_panel_state_pad_rows_contribute_log_noise():
    """Rows ≥ n_valid carry no kernel mass: the padded logdet is the
    unpadded one plus (N − n_valid)·log noise, and G is unchanged."""
    rng = np.random.default_rng(4)
    n, npad, noise = 200, 256, 0.3
    X = torch.tensor(rng.standard_normal((npad, 3)))
    m = torch.tensor(rng.standard_normal((npad, 2)))
    m[n:] = 0.0
    ld_pad, G_pad, _, _ = TCP.panel_state_rbf(X, m, 0.9, 1.2, noise, n_valid=n)
    ld, G, _, _ = TCP.panel_state_rbf(X[:n], m[:n], 0.9, 1.2, noise)
    np.testing.assert_allclose(float(ld_pad), float(ld) + (npad - n) * np.log(noise),
                               rtol=1e-12)
    np.testing.assert_allclose(G_pad.numpy(), G.numpy(), rtol=1e-10)


def test_panel_diag_blocks_match_pallas_interpret():
    """Mode "full+diag": T's diagonal blocks hold bf16(L_jj⁻¹) (lower
    triangle) as gpc_tpu's kernel stores them, within 2e-2 of their max —
    the bf16 rounding of the factor the blocks come from."""
    N, q, D = 512, 8, 2
    rng = np.random.default_rng(9)
    X = rng.standard_normal((N, q)).astype(np.float32)
    m = rng.standard_normal((N, D)).astype(np.float32)
    _, _, _, T_want = JCP.panel_state_rbf(
        jnp.asarray(X), jnp.asarray(m), jnp.float32(1.0), jnp.float32(1.0),
        jnp.float32(0.1), b=128, interpret=True, mode="full+diag")
    _, _, _, T = TCP.panel_state_rbf(torch.tensor(X, dtype=torch.float64),
                                     torch.tensor(m, dtype=torch.float64),
                                     1.0, 1.0, 0.1, mode="full+diag")
    want = TCP.diag_blocks(torch.from_numpy(np.asarray(T_want, np.float32)))
    got = TCP.diag_blocks(T.float())
    assert got.shape == (N // 128, 128, 128)
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(got.triu(1), torch.zeros_like(got))


def test_plain_T_layout_by_mode():
    """The plain version fills T to the kernel's contract: bf16 L below the
    diagonal blocks in both modes, zeros in them in mode "full", bf16(L_jj⁻¹)
    in mode "full+diag"; logdet, G and v do not depend on the mode."""
    rng = np.random.default_rng(10)
    X, m = torch.tensor(rng.standard_normal((300, 3))), torch.tensor(rng.standard_normal((300, 2)))
    full = TCP.panel_state_rbf(X, m, 0.9, 1.2, 0.2, mode="full")
    diag = TCP.panel_state_rbf(X, m, 0.9, 1.2, 0.2, mode="full+diag")
    for a, b in zip(full[:3], diag[:3]):
        assert torch.equal(a, b)
    T_full, T_diag = full[3], diag[3]
    nb = -(-300 // 128)
    blk = torch.arange(300) // 128
    same_block = blk[:, None] == blk[None, :]
    assert torch.equal(T_full[~same_block], T_diag[~same_block])
    assert torch.equal(T_full[same_block], torch.zeros_like(T_full[same_block]))
    K = TG.dist_gram_plain("rbf", [0.9, 1.2], X, X) + 0.2 * torch.eye(300, dtype=X.dtype)
    L = torch.linalg.cholesky(K)
    for j in range(nb):
        s = slice(128 * j, min(128 * j + 128, 300))
        want = torch.linalg.inv(L[s, s]).to(torch.bfloat16)
        assert torch.equal(T_diag[s, s], want.tril())
    below = ~same_block & (blk[:, None] > blk[None, :])
    assert torch.equal(T_full[below], L.to(torch.bfloat16)[below])
    with pytest.raises(ValueError, match="mode"):
        TCP.panel_state_rbf(X, m, 0.9, 1.2, 0.2, mode="diag")


@pytest.mark.parametrize("n,tol", [(192, 1e-9), (256, 1e-6), (96, 1e-9), (157, 1e-9)])
def test_chol_inv_block_plain_matches_pallas_interpret(n, tol):
    """K5's plain version against gpc_tpu's chol_inv_block in interpret
    mode, float64 inputs.  n = 96, 157 and 192 take the masked row kernel
    (chol_pallas.py:185), which computes in the input's dtype: 1e-9, as
    tests/test_chol_blocked.py.
    n = 256 takes the fused blocked Gauss-Jordan kernel, whose GEMMs
    accumulate in float32 (gpc_tpu/ops/chol_panel.py:77-80): 1e-6 of the
    largest entry."""
    from gpc_tpu.ops.chol_pallas import chol_inv_block as jax_chol_inv_block
    rng = np.random.default_rng(7)
    Z = rng.standard_normal((n, n))
    A = Z @ Z.T + n * np.eye(n)
    L_want, M_want = (np.asarray(a) for a in jax_chol_inv_block(jnp.asarray(A), interpret=True))
    L, M = TCP.chol_inv_block(torch.from_numpy(A))
    assert L.dtype == M.dtype == torch.float64
    for got, want in ((L, L_want), (M, M_want)):
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    np.testing.assert_allclose(M.numpy() @ L.numpy(), np.eye(n), atol=1e-9)
    assert not bool(torch.triu(L, 1).any()) and not bool(torch.triu(M, 1).any())
