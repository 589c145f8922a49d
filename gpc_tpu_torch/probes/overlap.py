"""K8a: can leaves hide under the Schur GEMMs; the slab stream; a leaf's parts.

Hopper versions of the three probes of tools/tpu_overlap_probe.py (design
and what each mode means on the H100 in csrc/probes.cu):

  overlap_probe     make_probe (:109): n_dots bf16 Schur GEMMs (RC, KC) x
                    (B, KC)ᵀ and n_leaves (L, L⁻¹) leaves of B x B (K5's
                    routine) in one kernel; `interleave` runs the leaf chain
                    beside the GEMMs, else after them.
  dma_probe         make_dma_probe (:158): n_iters bf16 (RC, KC) slabs from
                    device memory through shared memory, with or without a
                    dot per slab.
  leaf_parts_probe  make_leaf_parts_probe (:237): n repetitions of one part
                    of a leaf (sweep128, fsweep128, gemm512, gemm128, fdiag,
                    ffdiag).

Each returns the (8, 128) float32 corner the TPU probe returns, every
accumulator zero on entry; each has a plain version that computes it.  A CPU
tensor takes the plain version.  `overlap_plan` is the kernels' split of
the dots into blocks, overlap_probe's and dma_probe's (128 x 128 tiles of
acc, each tile's K over two blocks when twice the tiles fit the blocks that
run them).

    python -m gpc_tpu_torch.probes.overlap [--reps 3]

times them on the card at the TPU probe's shapes (RC = KC = 2048, B = 512)
with its differential pairs, and prints per-dot (with overlap_plan's K
split and without it), per-leaf, per-slab (and the stream's ms a call at
16 to 640 slabs) and per-part costs.  Needs CUDA.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.ops.chol_pallas import chol_inv_block_plain as _chol_inv
from gpc_tpu_torch.ops.chol_panel import LEAF
from gpc_tpu_torch.probes import bf16 as _bf16

RC, KC, B = 2048, 2048, 512
PARTS = ("sweep128", "fsweep128", "gemm512", "gemm128", "fdiag", "ffdiag")
_PN = 512      # the leaf-parts probe's wide block (fixed, as the TPU probe's)


def _grid() -> int:
    g = cuda_lib.library().gpc_probe_grid()
    if g < 2:
        raise RuntimeError("probe: fewer than two blocks are co-resident")
    return g


class OverlapPlan(NamedTuple):
    """overlap_probe's dots on the cooperative grid: units (K part s,
    target, 128 x 128 tile of acc), unit u on block first + u mod workers,
    as overlap_kernel walks them."""
    rc: int
    kc: int
    nb: int
    ntgt: int      # accumulators the dots alternate over (2 under indep)
    ksplit: int    # blocks a tile's contraction is split over
    first: int     # the first block that runs dots (1 when the leaves run beside them)
    workers: int   # blocks that run dots

    @property
    def units(self) -> int:
        return self.ksplit * self.ntgt * (self.rc // LEAF) * (self.nb // LEAF)

    @property
    def sms(self) -> int:
        """Blocks (one an SM) that run dots."""
        return min(self.units, self.workers)

    def unit(self, u: int, n_dots: int):
        """(block, tgt, r0, c0, k0, k1, dots) of unit u: rows r0 .. r0 +
        128 and columns c0 .. c0 + 128 of acc[tgt], contraction k0 .. k1 of
        the dots i = tgt, tgt + ntgt, ... < n_dots."""
        cts = self.nb // LEAF
        tiles = (self.rc // LEAF) * cts
        s, tgt, tile = u // (self.ntgt * tiles), u // tiles % self.ntgt, u % tiles
        ks = self.kc // self.ksplit
        return (self.first + u % self.workers, tgt, tile // cts * LEAF, tile % cts * LEAF,
                s * ks, (s + 1) * ks, range(tgt, n_dots, self.ntgt))


def overlap_plan(rc: int, kc: int, nb: int, n_dots: int, n_leaves: int, interleave: bool,
                 indep: bool, grid: int, ksplit: int | None = None) -> OverlapPlan:
    """The split of overlap_probe's dots (and dma_probe's, with no leaves)
    on `grid` co-resident blocks: the leaf chain takes block 0 when it runs
    beside the dots; each tile's K is split over two blocks when twice the
    tiles fit the rest and KC splits into 64-k chunks (`ksplit` forces a
    split)."""
    if rc <= 0 or rc % LEAF or nb <= 0 or nb % LEAF or kc <= 0 or kc % 64 or grid < 2:
        raise ValueError(f"overlap_plan: want RC and B multiples of 128, KC of 64 and two "
                         f"blocks; got RC = {rc}, KC = {kc}, B = {nb}, grid = {grid}")
    inter = interleave and n_leaves > 0
    ntgt = 2 if indep else 1
    first, workers = (1, grid - 1) if inter else (0, grid)
    tiles = ntgt * (rc // LEAF) * (nb // LEAF)
    if ksplit is None:
        ksplit = 2 if n_dots > 0 and 2 * tiles <= workers and kc % 128 == 0 else 1
    if ksplit < 1 or kc % (64 * ksplit):
        raise ValueError(f"overlap_plan: KC = {kc} does not split into {ksplit} parts of 64 k")
    return OverlapPlan(rc, kc, nb, ntgt, ksplit, first, workers)


# ---------------------------------------------------------------------------
# make_probe: dots and leaves in one kernel
# ---------------------------------------------------------------------------

def overlap_probe_plain(slab, vrow, aleaf, n_dots: int, n_leaves: int,
                        interleave: bool, indep: bool = False, overwrite: bool = False):
    """acc (2, RC, B) = 0; dot i: acc[tgt] −= bf16(slab[i % 2]) bf16(vrow)ᵀ
    (or = product + 1e-30 i under overwrite), tgt = i % 2 under indep, else
    0; leaf l: ld += 2 Σ log diag L + L⁻¹[0, 0] 1e-30 for aleaf + 1e-3 l I.
    Returns acc[0, :8, :128] + ld.  The order does not change the values,
    so `interleave` is accepted and unused."""
    del interleave
    rc, nb = slab.shape[1], vrow.shape[0]
    acc = torch.zeros((2, rc, nb), dtype=torch.float32, device=slab.device)
    vb = _bf16(vrow)
    for i in range(n_dots):
        tgt = i % 2 if indep else 0
        prod = _bf16(slab[i % 2]) @ vb.T
        acc[tgt] = prod + 1e-30 * i if overwrite else acc[tgt] - prod
    ld = torch.zeros((), dtype=torch.float64, device=slab.device)
    eye = torch.eye(aleaf.shape[0], dtype=torch.float32, device=aleaf.device)
    for l in range(n_leaves):
        L, M = _chol_inv(aleaf.float() + 1e-3 * l * eye)
        ld = ld + 2.0 * torch.log(torch.diagonal(L).double()).sum() + float(M[0, 0]) * 1e-30
    return acc[0, :8, :128] + ld.float()


def overlap_probe(slab, vrow, aleaf, n_dots: int, n_leaves: int, interleave: bool,
                  indep: bool = False, overwrite: bool = False, *, _ksplit: int | None = None,
                  _lw=None):
    """make_probe on the card: slab (2, RC, KC) and vrow (B, KC) bfloat16,
    aleaf (B, B) float32 PD; RC, B multiples of 128, KC of 64.  CPU: the
    plain version.  For timings and checks only: `_ksplit` forces the K
    split of the tiles (None: overlap_plan's choice); `_lw`, a float32 (3,
    B, B) tensor on the card, is the leaf chain's workspace: after the call
    _lw[1] and _lw[2] hold the last leaf's L and L⁻¹ (zeros above the
    diagonal)."""
    if slab.device.type == "cpu":
        return overlap_probe_plain(slab, vrow, aleaf, n_dots, n_leaves, interleave,
                                   indep, overwrite)
    cuda_lib.require_cuda("overlap_probe", aleaf)
    if slab.device != aleaf.device or vrow.device != aleaf.device:
        raise ValueError(f"overlap_probe: tensors on {slab.device}, {vrow.device}, "
                         f"{aleaf.device}; the kernel needs them on one card")
    _, rc, kc = slab.shape
    nb = vrow.shape[0]
    if (slab.dtype != torch.bfloat16 or vrow.dtype != torch.bfloat16 or slab.shape[0] != 2
            or vrow.shape[1] != kc or aleaf.shape != (nb, nb) or rc % LEAF or nb % LEAF
            or kc % 64 or not (slab.is_contiguous() and vrow.is_contiguous())):
        raise ValueError(f"overlap_probe: want bf16 slab (2, RC, KC), vrow (B, KC) and f32 "
                         f"aleaf (B, B), RC and B multiples of 128, KC of 64; got "
                         f"{tuple(slab.shape)}, {tuple(vrow.shape)}, {tuple(aleaf.shape)}")
    grid = _grid()
    plan = overlap_plan(rc, kc, nb, n_dots, n_leaves, interleave, indep, grid, _ksplit)
    dev = slab.device
    acc = torch.zeros((2, rc, nb), dtype=torch.float32, device=dev)
    part = (acc if plan.ksplit == 1 else
            torch.empty((plan.ksplit, 2, rc, nb), dtype=torch.float32, device=dev))
    lw = torch.empty((3, nb, nb), dtype=torch.float32, device=dev) if _lw is None else _lw
    if lw.shape != (3, nb, nb) or lw.dtype != torch.float32 or lw.device != dev \
            or not lw.is_contiguous():
        raise ValueError(f"overlap_probe: _lw wants a contiguous float32 (3, B, B) on {dev}")
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    cuda_lib.launch("overlap_probe", "gpc_overlap_probe", slab.data_ptr(), vrow.data_ptr(),
                    aleaf.data_ptr(), acc.data_ptr(), part.data_ptr(), lw.data_ptr(),
                    bar.data_ptr(), out.data_ptr(), rc, kc, nb, n_dots, n_leaves,
                    int(interleave), int(indep), int(overwrite), plan.ksplit, grid,
                    cuda_lib.stream_of(slab))
    return out


# ---------------------------------------------------------------------------
# make_dma_probe: the slab stream
# ---------------------------------------------------------------------------

def dma_probe_plain(hbm, vrow, n_iters: int, with_dots: bool):
    """acc (RC, B) = 0; slab i = hbm[i % n_bufs]: acc −= bf16 slab ·
    bf16(vrow)ᵀ with the dot, else acc[:8, :128] += slab[:8, :128].
    Returns acc[:8, :128]."""
    n_bufs = hbm.shape[0]
    if with_dots:
        acc = torch.zeros((hbm.shape[1], vrow.shape[0]), dtype=torch.float32,
                          device=hbm.device)
        vb = _bf16(vrow)
        for i in range(n_iters):
            acc = acc - _bf16(hbm[i % n_bufs]) @ vb.T
        return acc[:8, :128]
    acc = torch.zeros((8, 128), dtype=torch.float32, device=hbm.device)
    for i in range(n_iters):
        acc = acc + hbm[i % n_bufs, :8, :128].float()
    return acc


def dma_probe(hbm, vrow, n_iters: int, with_dots: bool):
    """make_dma_probe on the card: hbm (n_bufs, RC, KC) and vrow (B, KC)
    bfloat16; RC, B multiples of 128, KC of 256.  CPU: the plain version."""
    if hbm.device.type == "cpu":
        return dma_probe_plain(hbm, vrow, n_iters, with_dots)
    n_bufs, rc, kc = hbm.shape
    nb = vrow.shape[0]
    if hbm.device.type != "cuda" or vrow.device != hbm.device:
        raise ValueError(f"dma_probe: tensors on {hbm.device}, {vrow.device}; the kernel "
                         f"needs CUDA")
    if (hbm.dtype != torch.bfloat16 or vrow.dtype != torch.bfloat16 or vrow.shape[1] != kc
            or rc % LEAF or nb % LEAF or kc % 256 or n_iters < 1
            or not (hbm.is_contiguous() and vrow.is_contiguous())):
        raise ValueError(f"dma_probe: want bf16 hbm (n_bufs, RC, KC) and vrow (B, KC), RC "
                         f"and B multiples of 128, KC of 256; got {tuple(hbm.shape)}, "
                         f"{tuple(vrow.shape)}")
    grid = _grid()
    ksplit = overlap_plan(rc, kc, nb, n_iters, 0, False, False, grid).ksplit
    out = torch.zeros((8, 128), dtype=torch.float32, device=hbm.device)   # the dot's parts add in
    cuda_lib.launch("dma_probe", "gpc_dma_probe", hbm.data_ptr(), vrow.data_ptr(),
                    out.data_ptr(), rc, kc, nb, n_iters, n_bufs, int(with_dots), ksplit, grid,
                    cuda_lib.stream_of(hbm))
    return out


# ---------------------------------------------------------------------------
# make_leaf_parts_probe: where a leaf's time goes
# ---------------------------------------------------------------------------

def leaf_parts_probe_plain(kind: str, n: int, a512, a128):
    """acc (512, 512) = 0; n repetitions of the part at i = 0 .. n−1:
    sweep128 / fsweep128: acc[0, :128] += Σ_rows (L +) L⁻¹ of a128 + 1e-3 i;
    gemm512: acc = bf16(acc) bf16(a512) 1e-6 + 1e-9 i; gemm128: acc[:128,
    :128] = acc[:128, :128] a128 1e-6 + 1e-9 i (float32); fdiag: acc[0,
    :128] += Σ_rows (L + L⁻¹)[:, :128] of a512 + 1e-3 i; ffdiag: acc[0, :128]
    += Σ_rows L⁻¹[:, :128] + log|a512 + 1e-3 i|.  Returns acc[:8, :128]."""
    if kind not in PARTS:
        raise ValueError(f"leaf_parts_probe: kind {kind!r} (want one of {PARTS})")
    acc = torch.zeros((_PN, _PN), dtype=torch.float32, device=a512.device)
    for i in range(n):
        if kind in ("sweep128", "fsweep128"):
            L, M = _chol_inv(a128 + 1e-3 * i)
            acc[0, :128] += M.sum(0) + (L.sum(0) if kind == "sweep128" else 0.0)
        elif kind == "gemm512":
            acc = (_bf16(acc) @ _bf16(a512)) * 1e-6 + 1e-9 * i
        elif kind == "gemm128":
            acc[:128, :128] = (acc[:128, :128] @ a128) * 1e-6 + 1e-9 * i
        else:
            L, M = _chol_inv(a512 + 1e-3 * i)
            if kind == "fdiag":
                acc[0, :128] += L.sum(0)[:128] + M.sum(0)[:128]
            else:
                ld = 2.0 * torch.log(torch.diagonal(L)).sum()
                acc[0, :128] += M.sum(0)[:128] + ld
    return acc[:8, :128]


def leaf_parts_probe(kind: str, n: int, a512, a128):
    """make_leaf_parts_probe on the card, one block: a512 (512, 512) and
    a128 (128, 128) float32 PD.  CPU: the plain version."""
    if a512.device.type == "cpu":
        return leaf_parts_probe_plain(kind, n, a512, a128)
    if kind not in PARTS:
        raise ValueError(f"leaf_parts_probe: kind {kind!r} (want one of {PARTS})")
    cuda_lib.require_cuda("leaf_parts_probe", a512, a128)
    if a512.shape != (_PN, _PN) or a128.shape != (LEAF, LEAF):
        raise ValueError(f"leaf_parts_probe: want a512 (512, 512) and a128 (128, 128), "
                         f"got {tuple(a512.shape)}, {tuple(a128.shape)}")
    dev = a512.device
    acc = torch.zeros((_PN, _PN), dtype=torch.float32, device=dev)
    accb = torch.empty((_PN, _PN), dtype=torch.bfloat16, device=dev)
    w = torch.empty((3, _PN, _PN), dtype=torch.float32, device=dev)
    a512b = a512.to(torch.bfloat16)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    cuda_lib.launch("leaf_parts_probe", "gpc_leaf_parts", a512.data_ptr(), a128.data_ptr(),
                    a512b.data_ptr(), acc.data_ptr(), accb.data_ptr(), w.data_ptr(),
                    out.data_ptr(), PARTS.index(kind), n, cuda_lib.stream_of(a512))
    return out


# ---------------------------------------------------------------------------
# inputs and timings on the card
# ---------------------------------------------------------------------------

def probe_inputs(dev, rc=RC, kc=KC, b=B, n_bufs=2, seed=0):
    """The TPU probe's inputs (tools/tpu_overlap_probe.py:283-286, 339-342,
    363), from numpy's default_rng(seed): standard-normal bf16 slabs and
    vrow; aleaf, a512, a128 = 50 I + 0.01 Z with Z symmetrised.  The TPU
    probe's Z was not symmetric, which its masked sweep ignores (it reads
    the lower triangle, as Cholesky does); K2's sweep reads the pivot row,
    so a leaf's input is the symmetric PD block a factorization gives it.

    gleaf, g512, g128 (for the checks, not the timings): rbf Gram blocks
    of as many standard-normal points in 2-D, lengthscale 1, plus 0.1 I.
    Near 50 I a leaf's logdet is about Σ log A_ii whatever the factor does;
    a Gram block's off-diagonal mass moves it by far more than the limits
    when a panel solve, a trailing update or the noise is missing."""
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=dev)

    def pd(n):
        Z = rng.standard_normal((n, n))
        return t(np.eye(n) * 50.0 + 0.005 * (Z + Z.T), torch.float32)

    def gram(n):
        X = rng.standard_normal((n, 2))
        d2 = ((X[:, None] - X[None]) ** 2).sum(-1)
        return t(np.exp(-0.5 * d2) + 0.1 * np.eye(n), torch.float32)
    slab = t(rng.standard_normal((2, rc, kc)), torch.bfloat16)
    vrow = t(rng.standard_normal((b, kc)), torch.bfloat16)
    aleaf, a512, a128 = pd(b), pd(_PN), pd(LEAF)
    hbm = t(rng.standard_normal((n_bufs, rc, kc)), torch.bfloat16)
    gleaf, g512, g128 = gram(b), gram(_PN), gram(LEAF)
    return dict(slab=slab, vrow=vrow, aleaf=aleaf, a512=a512, a128=a128, hbm=hbm, gleaf=gleaf,
                g512=g512, g128=g128)


def main(argv=None):
    from gpc_tpu_torch.probes import cuda_ms, graph_ms, require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(require_card(), flush=True)
    dev = torch.device("cuda")
    inp = probe_inputs(dev, n_bufs=64)
    s, v, al, r = inp["slab"], inp["vrow"], inp["aleaf"], a.reps
    flop = 2 * RC * KC * B
    times = {}
    grid = _grid()
    for name, nd, nl, inter, indep, ks in (("dots-640", 640, 0, False, False, None),
                                           ("dots-64", 64, 0, False, False, None),
                                           ("dotsU-640", 640, 0, False, False, 1),
                                           ("dotsU-64", 64, 0, False, False, 1),
                                           ("dotsI-640", 640, 0, False, True, None),
                                           ("dotsI-64", 64, 0, False, True, None),
                                           ("leaves-64", 0, 64, False, False, None),
                                           ("leaves-8", 0, 8, False, False, None),
                                           ("seq-640+20", 640, 20, False, False, None),
                                           ("inter-640+20", 640, 20, True, False, None),
                                           ("seq-640+80", 640, 80, False, False, None),
                                           ("inter-640+80", 640, 80, True, False, None)):
        times[name] = cuda_ms(
            lambda: overlap_probe(s, v, al, nd, nl, inter, indep, _ksplit=ks), r)
        print(f"{name:14s} {times[name]} ms", flush=True)
    for tag, indep, ks in (("", False, None), ("U", False, 1), ("I", True, None)):
        plan = overlap_plan(RC, KC, B, 64, 0, False, indep, grid, ks)
        us = (times[f"dots{tag}-640"] - times[f"dots{tag}-64"]) / 576 * 1e3
        print(f"per-dot{' independent' if indep else ''} (differential, K split "
              f"{plan.ksplit}, {plan.sms} SMs): {us} us ({flop / us / 1e6} TFLOP/s)", flush=True)
    print(f"per-leaf (differential): {(times['leaves-64'] - times['leaves-8']) / 56 * 1e3} us",
          flush=True)
    for nl in (20, 80):
        seq = (times[f"seq-640+{nl}"] - times["dots-640"]) * 1e3 / nl
        inter = (times[f"inter-640+{nl}"] - times["dots-640"]) * 1e3 / nl
        print(f"leaf marginal cost over dots ({nl} leaves): sequential {seq} us/leaf, "
              f"interleaved {inter} us/leaf", flush=True)
    for kind, lo, hi in (("sweep128", 16, 160), ("fsweep128", 16, 160), ("gemm512", 64, 640),
                         ("gemm128", 64, 640), ("fdiag", 8, 80), ("ffdiag", 8, 80)):
        ts = [cuda_ms(lambda: leaf_parts_probe(kind, n, inp["a512"], inp["a128"]), r)
              for n in (lo, hi)]
        print(f"{kind:10s} {(ts[1] - ts[0]) / (hi - lo) * 1e3} us each (differential)",
              flush=True)
    for with_dots in (False, True):
        ts = {n: cuda_ms(lambda: dma_probe(inp["hbm"], v, n, with_dots), r)
              for n in (16, 64, 160, 640)}
        per = (ts[640] - ts[64]) / 576 * 1e-3
        extra = f", {flop / per / 1e12} TFLOP/s" if with_dots else ""
        print(f"{'dma+dots' if with_dots else 'dma-only':12s} {per * 1e6} us/slab "
              f"({RC * KC * 2 / per / 1e9} GB/s{extra}); ms a call at 16/64/160/640 slabs "
              f"{list(ts.values())}, 16 -> 64: {(ts[64] - ts[16]) / 48 * 1e3} us/slab",
              flush=True)
        gs = {n: graph_ms(lambda: dma_probe(inp["hbm"], v, n, with_dots)) for n in (16, 64)}
        print(f"{'':12s} in a CUDA graph, ms a call at 16/64 slabs {list(gs.values())}, "
              f"16 -> 64: {(gs[64] - gs[16]) / 48 * 1e3} us/slab", flush=True)


if __name__ == "__main__":
    main()
