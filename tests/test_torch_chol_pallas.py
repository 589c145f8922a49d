"""K5 and K6 (gpc_tpu_torch/ops/chol_pallas.py) against gpc_tpu's
chol_pallas kernels in interpret mode, on the CPU.

  * chol_block's plain version (torch.linalg.cholesky) against gpc_tpu's
    `chol_block(interpret=True)`, the masked column sweep, at n = 96, 157,
    192 and 256; float64, whose sweep computes in the input's dtype: 1e-9 of
    the largest entry.
  * chol_inv_block at ragged n against gpc_tpu's masked sweep and
    forward-substitution inverse (chol_pallas.py:185) is in
    tests/test_torch_chol_panel.py, beside its whole-block cases.
  * both plain versions against gpc_tpu's interpret-mode kernels at the
    ragged n = 1, 129 and 1000 (chol_block's column sweep; chol_inv_block's
    masked sweep and forward-substitution inverse), float64, 1e-9.
  * the launch plan of the card's blocked factorization (`chol_plan`):
    every lower 128-tile of the padded block is finished exactly once (the
    leaf on the diagonal, the panel solve below it), after every trailing
    update that it needs and before any step that reads it, for np = 128,
    256, 640 and 1024; with the inverse, every tile below the diagonal of
    L⁻¹ once, diagonal by diagonal.
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
    pol = dict(base=256, leafinv="pallas")
    ld_j, q_j = JEF.evidence_left_fast(JLE.kern_block_fn(jk, jnp.asarray(p), jnp.asarray(X)),
                                       625, jnp.asarray(m),
                                       JEF.Policy(bf16=False, stack=True, **pol))
    ld_t, q_t = TEF.evidence_left_fast(TLE.kern_block_fn(tk, torch.from_numpy(p),
                                                         torch.from_numpy(X)),
                                       625, torch.from_numpy(m), TEF.Policy(**pol))
    assert TEF.Policy(**pol) == TEF.Policy()
    assert ld_t.dtype == torch.float64
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-8)
    np.testing.assert_allclose(float(q_t), float(q_j), rtol=1e-8)


@pytest.mark.parametrize("n", [1, 129, 1000])
def test_plain_versions_match_pallas_interpret_at_ragged_n(n):
    A = _spd(n, n + 3)
    L = TCPL.chol_block(torch.from_numpy(A))
    _close(L.numpy(), JCPL.chol_block(jnp.asarray(A), interpret=True), 1e-9)
    L, M = TCPL.chol_inv_block(torch.from_numpy(A))
    L_want, M_want = JCPL.chol_inv_block(jnp.asarray(A), interpret=True)
    _close(L.numpy(), L_want, 1e-9)
    _close(M.numpy(), M_want, 1e-9)
    assert L.shape == M.shape == (n, n)


def _finished_at(plan):
    """{tile: step index} of the step that finishes each tile of L (the
    leaf or the panel solve), checking that none is finished twice."""
    done = {}
    for q, (kind, p, tiles) in enumerate(plan):
        if kind in (TCPL.LEAF_STEP, TCPL.SOLVE_STEP):
            for t in tiles:
                assert t not in done, f"tile {t} finished twice"
                done[t] = q
    return done


@pytest.mark.parametrize("npad", [128, 256, 640, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_chol_plan_covers_every_lower_tile_once(npad, inverse):
    nbl = npad // 128
    plan = TCPL.chol_plan(nbl, inverse)
    lower = {(i, j) for i in range(nbl) for j in range(i + 1)}
    done = _finished_at(plan)
    assert set(done) == lower
    for q, (kind, p, tiles) in enumerate(plan):
        if kind == TCPL.LEAF_STEP:
            assert tiles == [(p, p)]
        elif kind == TCPL.SOLVE_STEP:
            assert all(j == p and i > p for i, j in tiles) and done[(p, p)] < q
        elif kind == TCPL.UPDATE_STEP:
            # reads L's column p (finished) and updates tiles finished later
            assert all(done[(i, p)] < q and done[(j, p)] < q < done[(i, j)]
                       for i, j in tiles)
    updates = [(p, t) for kind, p, ts in plan if kind == TCPL.UPDATE_STEP for t in ts]
    want = [(p, (i, j)) for i in range(nbl) for j in range(1, i + 1) for p in range(j)]
    assert sorted(updates) == sorted(want)   # each (p, tile) exactly once
    inv = [(d, t) for kind, d, ts in plan if kind == TCPL.INV_STEP for t in ts]
    if not inverse:
        assert inv == []
    else:
        assert sorted(t for _, t in inv) == sorted((i, j) for i, j in lower if i > j)
        assert all(i - j == d for d, (i, j) in inv)
        assert [d for d, _ in inv] == sorted(d for d, _ in inv)   # earlier diagonals first
        assert max(done.values()) < min(q for q, s in enumerate(plan) if s[0] == TCPL.INV_STEP) \
            if nbl > 1 else True
    steps, tiles = TCPL._packed_plan(nbl, inverse, "cpu")
    assert steps.shape == (len(plan), 4) and tiles.shape == (sum(len(s[2]) for s in plan), 2)
    for (kind, p, first, count), (k, pp, ts) in zip(steps.tolist(), plan):
        assert (kind, p) == (k, pp) and tiles[first:first + count].tolist() == [list(t) for t in ts]
    assert TCPL.plan_kernels(npad, inverse) == len(plan)
    assert TCPL.plan_kernels(npad - 5, inverse) == len(plan) + 1   # the padding copy
