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
tensor takes the plain version.

    python -m gpc_tpu_torch.probes.overlap [--reps 3]

times them on the card at the TPU probe's shapes (RC = KC = 2048, B = 512)
with its differential pairs, and prints per-dot, per-leaf, per-slab and
per-part costs.  Needs CUDA.
"""

from __future__ import annotations

import argparse

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
                  indep: bool = False, overwrite: bool = False):
    """make_probe on the card: slab (2, RC, KC) and vrow (B, KC) bfloat16,
    aleaf (B, B) float32 PD; RC, B multiples of 128, KC of 64.  CPU: the
    plain version."""
    if slab.device.type == "cpu":
        return overlap_probe_plain(slab, vrow, aleaf, n_dots, n_leaves, interleave,
                                   indep, overwrite)
    cuda_lib.require_cuda("overlap_probe", aleaf)
    _, rc, kc = slab.shape
    nb = vrow.shape[0]
    if (slab.dtype != torch.bfloat16 or vrow.dtype != torch.bfloat16 or slab.shape[0] != 2
            or vrow.shape[1] != kc or aleaf.shape != (nb, nb) or rc % LEAF or nb % LEAF
            or kc % 64 or not (slab.is_contiguous() and vrow.is_contiguous())):
        raise ValueError(f"overlap_probe: want bf16 slab (2, RC, KC), vrow (B, KC) and f32 "
                         f"aleaf (B, B), RC and B multiples of 128, KC of 64; got "
                         f"{tuple(slab.shape)}, {tuple(vrow.shape)}, {tuple(aleaf.shape)}")
    dev = slab.device
    acc = torch.zeros((2, rc, nb), dtype=torch.float32, device=dev)
    lw = torch.empty((3, nb, nb), dtype=torch.float32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    cuda_lib.launch("overlap_probe", "gpc_overlap_probe", slab.data_ptr(), vrow.data_ptr(),
                    aleaf.data_ptr(), acc.data_ptr(), lw.data_ptr(), bar.data_ptr(),
                    out.data_ptr(), rc, kc, nb, n_dots, n_leaves, int(interleave),
                    int(indep), int(overwrite), _grid(), cuda_lib.stream_of(slab))
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
    if (hbm.dtype != torch.bfloat16 or vrow.dtype != torch.bfloat16 or vrow.shape[1] != kc
            or rc % LEAF or nb % LEAF or kc % 256 or n_iters < 1
            or not (hbm.is_contiguous() and vrow.is_contiguous())):
        raise ValueError(f"dma_probe: want bf16 hbm (n_bufs, RC, KC) and vrow (B, KC), RC "
                         f"and B multiples of 128, KC of 256; got {tuple(hbm.shape)}, "
                         f"{tuple(vrow.shape)}")
    out = torch.empty((8, 128), dtype=torch.float32, device=hbm.device)
    cuda_lib.launch("dma_probe", "gpc_dma_probe", hbm.data_ptr(), vrow.data_ptr(),
                    out.data_ptr(), rc, kc, nb, n_iters, n_bufs, int(with_dots), _grid(),
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
    so a leaf's input is the symmetric PD block a factorization gives it."""
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=dev)

    def pd(n):
        Z = rng.standard_normal((n, n))
        return t(np.eye(n) * 50.0 + 0.005 * (Z + Z.T), torch.float32)
    slab = t(rng.standard_normal((2, rc, kc)), torch.bfloat16)
    vrow = t(rng.standard_normal((b, kc)), torch.bfloat16)
    aleaf, a512, a128 = pd(b), pd(_PN), pd(LEAF)
    hbm = t(rng.standard_normal((n_bufs, rc, kc)), torch.bfloat16)
    return dict(slab=slab, vrow=vrow, aleaf=aleaf, a512=a512, a128=a128, hbm=hbm)


def main(argv=None):
    from gpc_tpu_torch.probes import cuda_ms, require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(require_card(), flush=True)
    dev = torch.device("cuda")
    inp = probe_inputs(dev, n_bufs=64)
    s, v, al, r = inp["slab"], inp["vrow"], inp["aleaf"], a.reps
    flop = 2 * RC * KC * B
    times = {}
    for name, nd, nl, inter, indep in (("dots-640", 640, 0, False, False),
                                       ("dots-64", 64, 0, False, False),
                                       ("dotsI-640", 640, 0, False, True),
                                       ("dotsI-64", 64, 0, False, True),
                                       ("leaves-64", 0, 64, False, False),
                                       ("leaves-8", 0, 8, False, False),
                                       ("seq-640+20", 640, 20, False, False),
                                       ("inter-640+20", 640, 20, True, False),
                                       ("seq-640+80", 640, 80, False, False),
                                       ("inter-640+80", 640, 80, True, False)):
        times[name] = cuda_ms(lambda: overlap_probe(s, v, al, nd, nl, inter, indep), r)
        print(f"{name:14s} {times[name]} ms", flush=True)
    for tag in ("", "I"):
        us = (times[f"dots{tag}-640"] - times[f"dots{tag}-64"]) / 576 * 1e3
        print(f"per-dot{' independent' if tag else ''} (differential): {us} us "
              f"({flop / us / 1e6} TFLOP/s)", flush=True)
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
        ts = [cuda_ms(lambda: dma_probe(inp["hbm"], v, n, with_dots), r) for n in (64, 640)]
        per = (ts[1] - ts[0]) / 576 * 1e-3
        extra = f", {flop / per / 1e12} TFLOP/s" if with_dots else ""
        print(f"{'dma+dots' if with_dots else 'dma-only':12s} {per * 1e6} us/slab "
              f"({RC * KC * 2 / per / 1e9} GB/s{extra})", flush=True)


if __name__ == "__main__":
    main()
