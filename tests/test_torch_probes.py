"""The Hopper probes' plain versions (gpc_tpu_torch/probes) against the TPU
probes of tools/, on the CPU.

The tools/ modules are loaded from their paths with importlib (they are not
a package) and their Pallas kernels run in TPU interpret mode, with scratch
memory zero on entry, as the Hopper kernels' accumulators are.

  * K7, evidence_mega_rbf_plain, against tools/chol_mega_v2.py's
    evidence_mega_rbf(interpret=True) at N = 384, b = 128, q = 3.  Both keep
    the bf16 policy (bf16-rounded GEMM inputs, float32 sums); they differ in
    the leaf (torch's Cholesky vs the masked sweep, both float32), whose
    last-bit differences flip a few bf16 roundings of L: 2e-4 relative on
    logdet and quad, well under the policy's 2.5e-3 drift from float64.
    Mode "noleaf" has no sweep: 1e-5.
  * K8a, each probe of tools/tpu_overlap_probe.py with RC, KC, B cut to 256,
    256, 128: the (8, 128) corner within 1e-5 of its largest entry where it
    holds bf16 products summed in float32 in another order (the slab
    stream), 5e-5 where it also holds sums of float32 leaves (torch's
    Cholesky and triangular inverse against the TPU's sweeps).

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).  K7's work list (chol_mega.
mega_plan), which its blocks walk with a ticket, is checked here at nb = 3,
4, 16 and 128 on grids of 2 to 132 blocks: each column of each tile's
correction in exactly one range, each item after all it waits for (the
kernel's rules, written out again here), tile (j+1, j) first in its column,
and nb < 3 or fewer than two blocks refused.  K8a's split of the overlap's
dots (overlap.overlap_plan), which the kernel reads as its block walk, is
checked here for giving every tile of acc every 64-k chunk of each dot
once at the card tests' shapes and the TPU probe's; the three K8a wrappers
refuse a tensor that is on neither the CPU nor the card.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpc_tpu_torch.probes import chol_mega as TCM
from gpc_tpu_torch.probes import overlap as TOV

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tools_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mega_v2():
    return _load("chol_mega_v2")


@pytest.fixture(scope="module")
def jprobe():
    return _load("tpu_overlap_probe")


@pytest.fixture
def small(jprobe, monkeypatch):
    """The TPU probe at RC = KC = 256, B = 128, in interpret mode; the same
    numpy inputs as jax and torch arrays."""
    for name, val in (("RC", 256), ("KC", 256), ("B", 128)):
        monkeypatch.setattr(jprobe, name, val)
    inp = TOV.probe_inputs("cpu", rc=256, kc=256, b=128, n_bufs=3, seed=1)
    as_jax = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16 if v.dtype == torch.bfloat16
                             else jnp.float32) for k, v in inp.items()}
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        yield jprobe, inp, as_jax


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mode,tol", [("full", 2e-4), ("noleaf", 1e-5)])
def test_evidence_mega_plain_matches_tpu_interpret(mega_v2, mode, tol):
    rng = np.random.default_rng(3)
    X, m = rng.standard_normal((384, 3)), rng.standard_normal((384, 2))
    ld_j, q_j = mega_v2.evidence_mega_rbf(jnp.asarray(X), jnp.asarray(m), jnp.float64(0.5),
                                          jnp.float64(1.0), jnp.float64(0.3), b=128,
                                          interpret=True, mode=mode)
    ld_t, q_t = TCM.evidence_mega_rbf(torch.from_numpy(X), torch.from_numpy(m), 0.5, 1.0, 0.3,
                                      b=128, mode=mode)
    assert ld_t.dtype == q_t.dtype == torch.float32
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=tol)
    np.testing.assert_allclose(float(q_t), float(q_j), rtol=tol)


def test_evidence_mega_plain_near_float64_evidence():
    """The bf16 policy's drift from the float64 evidence at the panel
    phase's inputs (q = 8, γ = var = 1) at noise 0.3: inside gpc_tpu's
    panel bound, 2e-3 relative (1.3e-4 and 1.8e-4 here)."""
    rng = np.random.default_rng(4)
    X, m = rng.standard_normal((512, 8)), rng.standard_normal((512, 1))
    ld, quad = TCM.evidence_mega_rbf(torch.from_numpy(X), torch.from_numpy(m), 1.0, 1.0, 0.3)
    Xs = X * np.sqrt(0.5)
    d2 = np.maximum((Xs ** 2).sum(1)[:, None] + (Xs ** 2).sum(1)[None] - 2 * Xs @ Xs.T, 0)
    L = np.linalg.cholesky(np.exp(-d2) + 0.3 * np.eye(512))
    v = np.linalg.solve(L, m)
    np.testing.assert_allclose(float(ld), 2 * np.log(np.diag(L)).sum(), rtol=2e-3)
    np.testing.assert_allclose(float(quad), (v ** 2).sum(), rtol=2e-3)


def test_evidence_mega_rejects_what_the_schedule_does_not_take():
    X, m = torch.zeros((256, 3)), torch.zeros((256, 1))
    with pytest.raises(ValueError, match="nb >= 3"):
        TCM.evidence_mega_rbf(X, m, 1.0, 1.0, 0.1)
    with pytest.raises(ValueError, match="mode"):
        TCM.evidence_mega_rbf(torch.zeros((384, 3)), torch.zeros((384, 1)), 1.0, 1.0, 0.1,
                              mode="fast")


def _plan_waits(plan):
    """What each item of K7's list waits for, by the kernel's rules
    (csrc/chol_mega.cu), as list positions: a range (i, j, k0, k1) on tiles
    (i, k1 - 1) and (j, k1 - 1) done, on tile (i, j)'s running sum up to k0
    and, if it is the tile's last (k1 = j), on leaf j; leaf j on tile (j,
    j - 1) done.  A tile is done at its last item."""
    done, upto, leaf = {}, {}, {}
    for x, (kind, i, j, k0, k1) in enumerate(plan):
        if kind == TCM.LEAF_ITEM:
            leaf[j] = x
        else:
            upto[(i, j, k1)] = x
            if k1 == j:
                done[(i, j)] = x
    waits = []
    for kind, i, j, k0, k1 in plan:
        if kind == TCM.LEAF_ITEM:
            waits.append([done[(j, j - 1)]] if j else [])
            continue
        w = [done[(i, k1 - 1)], done[(j, k1 - 1)]] if k1 else []
        if k0:
            w.append(upto[(i, j, k0)])
        if k1 == j:
            w.append(leaf[j])
        waits.append(w)
    return waits


@pytest.mark.parametrize("nb", [3, 4, 16, 128])
@pytest.mark.parametrize("grid", [2, 3, 7, 66, 132])
def test_mega_plan_covers_each_tile_once_and_orders_its_waits(nb, grid):
    """K7's work list: every tile (i, j) of the strict lower triangle has
    each column k < j of its correction in exactly one range and one last
    range (k1 = j; j = 0: the epilogue alone); every leaf once, in order;
    every item after all it waits for, so that blocks taking items in list
    order with a ticket and block 0 running the leaves finish on any grid
    of two or more co-resident blocks; and in each column tile (j+1, j)'s
    last item before every other tile's of that column (lookahead)."""
    plan = TCM.mega_plan(nb, grid)
    assert plan.dtype == np.int32 and plan.shape[1] == 5 and not plan.flags.writeable
    kinds = plan[:, 0]
    assert set(kinds.tolist()) == {TCM.LEAF_ITEM, TCM.RANGE_ITEM}
    assert plan[kinds == TCM.LEAF_ITEM, 2].tolist() == list(range(nb))
    cover = {(i, j): np.zeros(max(j, 1), int) for j in range(nb) for i in range(j + 1, nb)}
    lasts = {}
    for x, (kind, i, j, k0, k1) in enumerate(plan):
        if kind == TCM.LEAF_ITEM:
            continue
        assert 0 <= j < i < nb and 0 <= k0 <= k1 <= j
        assert k1 > k0 or (j == 0 and k0 == k1 == 0)
        cover[(i, j)][k0:k1] += 1
        if k1 == j:
            assert (i, j) not in lasts
            lasts[(i, j)] = x
    assert set(lasts) == set(cover)
    for (i, j), c in cover.items():
        assert (c[:j] == 1).all(), (i, j)
    for x, w in enumerate(_plan_waits(plan)):
        assert all(y < x for y in w), (plan[x], [plan[y] for y in w if y >= x])
    for j in range(nb - 1):
        assert lasts[(j + 1, j)] == min(lasts[(i, j)] for i in range(j + 1, nb))


@pytest.mark.parametrize("nb,grid", [(2, 132), (0, 132), (16, 1), (16, 0)])
def test_mega_plan_rejects_what_the_kernel_cannot_take(nb, grid):
    with pytest.raises(ValueError, match="mega_plan"):
        TCM.mega_plan(nb, grid)


def test_mega_ranges_split_late_corrections():
    """A tile's correction splits into ranges of RANGE_COLS columns from 0,
    the last one the rest, so most of a late tile's correction is ready
    long before its column comes up."""
    assert TCM.mega_ranges(0) == [(0, 0)]
    assert TCM.mega_ranges(5) == [(0, 5)]
    r = TCM.RANGE_COLS
    assert TCM.mega_ranges(2 * r + 3) == [(0, r), (r, 2 * r), (2 * r, 2 * r + 3)]
    assert TCM.mega_ranges(2 * r) == [(0, r), (r, 2 * r)]


@pytest.mark.parametrize("n_dots,n_leaves,interleave,indep,overwrite",
                         [(3, 0, False, False, False), (0, 2, False, False, False),
                          (4, 2, True, False, False), (4, 2, False, True, False),
                          (4, 1, False, False, True)])
def test_overlap_probe_plain_matches_tpu_interpret(small, n_dots, n_leaves, interleave,
                                                    indep, overwrite):
    jprobe, inp, jx = small
    want = jprobe.make_probe(n_dots, n_leaves, interleave, indep, overwrite)(
        jx["slab"], jx["vrow"], jx["aleaf"])
    got = TOV.overlap_probe(inp["slab"], inp["vrow"], inp["aleaf"], n_dots, n_leaves,
                            interleave, indep, overwrite)
    _close(got, want, 5e-5)


@pytest.mark.parametrize("with_dots", [False, True])
def test_dma_probe_plain_matches_tpu_interpret(small, with_dots):
    jprobe, inp, jx = small
    want = jprobe.make_dma_probe(5, 3, with_dots)(jx["hbm"], jx["vrow"])
    got = TOV.dma_probe(inp["hbm"], inp["vrow"], 5, with_dots)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", TOV.PARTS)
def test_leaf_parts_probe_plain_matches_tpu_interpret(small, kind):
    jprobe, inp, jx = small
    want = jprobe.make_leaf_parts_probe(kind, 2)(jx["a512"], jx["a128"])
    got = TOV.leaf_parts_probe(kind, 2, inp["a512"], inp["a128"])
    _close(got, want, 5e-5)


@pytest.mark.parametrize("rc,kc,nb,n_dots,n_leaves,interleave,indep,ksplit", [
    (512, 512, 256, 3, 0, False, False, 2), (512, 512, 256, 4, 2, True, False, 2),
    (512, 512, 256, 4, 2, False, True, 2), (512, 512, 256, 4, 1, False, False, 2),
    (256, 256, 128, 3, 2, True, False, 2), (256, 256, 384, 3, 2, True, False, 2),
    (256, 256, 512, 3, 2, False, False, 2), (128, 256, 256, 1, 0, False, True, 2),
    (128, 256, 256, 0, 0, False, True, 1), (256, 128, 256, 5, 0, False, False, 2),
    (256, 128, 256, 5, 0, False, True, 2), (2048, 2048, 512, 64, 8, True, False, 2),
    (2048, 2048, 512, 64, 0, False, True, 1), (2048, 2048, 512, 64, 0, False, False, 2)])
def test_overlap_plan_covers_each_tile_and_k_once(rc, kc, nb, n_dots, n_leaves, interleave,
                                                  indep, ksplit):
    """overlap_plan's units, read as overlap_kernel reads them on the H100's
    132 co-resident blocks, give every 128 x 128 tile of acc[i mod 2] (of
    acc[0] without indep) every 64-k chunk of each dot i exactly once, and
    run on the blocks that do not hold the leaf chain.  The card tests'
    shapes and the TPU probe's; KC = 128 leaves each part one 64-k box."""
    plan = TOV.overlap_plan(rc, kc, nb, n_dots, n_leaves, interleave, indep, 132)
    assert plan.ksplit == ksplit
    seen = np.zeros((2, rc // 128, nb // 128, max(n_dots, 1), kc // 64), int)
    for u in range(plan.units):
        block, tgt, r0, c0, k0, k1, dots = plan.unit(u, n_dots)
        assert plan.first <= block < plan.first + plan.workers
        assert r0 % 128 == 0 and c0 % 128 == 0 and k0 % 64 == 0 and k1 - k0 == kc // ksplit
        for i in dots:
            seen[tgt, r0 // 128, c0 // 128, i, k0 // 64:k1 // 64] += 1
    for i in range(n_dots):
        tgt = i % 2 if indep else 0
        assert (seen[tgt, :, :, i] == 1).all() and (seen[1 - tgt, :, :, i] == 0).all()
    assert plan.first == (1 if interleave and n_leaves else 0)
    assert plan.sms == min(plan.units, plan.workers)


def test_overlap_plan_at_the_tpu_probe_shapes():
    """RC = KC = 2048, B = 512: the 64 dependent tiles split K over 128 of
    the 131 blocks beside the leaf chain; the 128 independent tiles do not
    split (256 parts would not fit 132 blocks)."""
    inter = TOV.overlap_plan(2048, 2048, 512, 64, 8, True, False, 132)
    assert (inter.ksplit, inter.units, inter.sms, inter.first) == (2, 128, 128, 1)
    indep = TOV.overlap_plan(2048, 2048, 512, 64, 0, False, True, 132)
    assert (indep.ksplit, indep.units, indep.sms) == (1, 128, 128)
    unsplit = TOV.overlap_plan(2048, 2048, 512, 64, 0, False, False, 132, ksplit=1)
    assert (unsplit.units, unsplit.sms) == (64, 64)


@pytest.mark.parametrize("args", [(200, 256, 128, 1, 0, False, False, 132),
                                  (256, 96, 128, 1, 0, False, False, 132),
                                  (256, 256, 128, 1, 0, False, False, 1),
                                  (256, 192, 128, 1, 0, False, False, 132, 2)])
def test_overlap_plan_rejects_what_the_kernel_cannot_split(args):
    with pytest.raises(ValueError, match="overlap_plan"):
        TOV.overlap_plan(*args)


@pytest.mark.parametrize("call", [
    lambda m: TOV.dma_probe(m((2, 128, 256), torch.bfloat16), m((128, 256), torch.bfloat16), 1,
                            False),
    lambda m: TOV.overlap_probe(m((2, 128, 256), torch.bfloat16), m((128, 256), torch.bfloat16),
                                m((128, 128)), 1, 0, False),
    lambda m: TOV.leaf_parts_probe("gemm128", 1, m((512, 512)), m((128, 128)))])
def test_k8a_wrappers_refuse_tensors_off_the_card(call):
    """A tensor that is neither on the CPU nor on the card raises; it is
    never launched."""
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta"))
