"""K8b: which operand layout do the tensor cores take at full rate?

Hopper version of tools/tpu_dotform_probe.py (make_kernel :44-65, the call
at :88): the sum over `reps` of one bf16 product with float32 accumulation,
contraction width K, output (B, B), in three forms:

  c0    Aᵀ Bv, A and Bv (K, B)   (K3's Schur correction and K7's slots,
                                  ViᵀVj: both operands k-major)
  std   A Bv,  A (B, K), Bv (K, B)
  dotT  A Bvᵀ, A and Bv (B, K)   (both row-major)

The kernel (csrc/probes_dots.cu) loads each block's K-slice of both
operands into shared memory once by TMA, as the TPU kernel read its
operands before its loop, and computes every one of the `reps` products
with wgmma, each form's operands in their own layout (wgmma's transpose
bits: c0's both MN-major, dotT's both K-major).  `dot_plan` is its split
of the work into blocks.  A CPU tensor takes the plain version.

    python -m gpc_tpu_torch.probes.dotform [--reps 3]

times the three forms on the card at the TPU probe's shapes (K = 8192,
B = 512, REPS = 1024) by differential pairs (1024 and 64 products), beside
one `torch.matmul` (cuBLAS) of the same operands and form per product, the
counterpart of the TPU probe's XLA loop (:107-129).  Needs CUDA.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.probes import bf16 as _bf16

K, B, REPS = 8192, 512, 1024
FORMS = ("c0", "std", "dotT")
PATTERNS = ("hoisted", "read_each", "reshape_each", "dynslot")   # K8c's (probes/refread.py)
KS = 256      # the kernel's K-slice: a block's share of the contraction
TILE = 128    # a block's output tile: TILE x TILE
BF16_PEAK = 989e12   # the H100's dense bf16 tensor-core rate (FLOP/s), the probes' bound


class DotPlan(NamedTuple):
    """The kernel's split of one call: nt² output tiles of TILE x TILE
    times `slices` slices of ks along the contraction, one block each."""
    ks: int
    nt: int
    slices: int

    @property
    def blocks(self) -> int:
        return self.nt ** 2 * self.slices

    def block(self, i: int):
        """(r0, s0, k0, k1) of block i: output rows r0 .. r0 + TILE,
        columns s0 .. s0 + TILE, contraction k0 .. k1, as dots_kernel
        reads blockIdx.x (tile i mod nt², slice i // nt²)."""
        tile, s = i % self.nt ** 2, i // self.nt ** 2
        return (tile // self.nt) * TILE, (tile % self.nt) * TILE, s * self.ks, (s + 1) * self.ks

    @property
    def streamed_bytes(self) -> int:
        """Bytes of A that the streamed patterns read from L2 a product:
        each block its TILE x ks slice (A once per column tile)."""
        return self.blocks * TILE * self.ks * 2


def dot_plan(k: int, b: int) -> DotPlan:
    """The blocks of a call at contraction k (a multiple of KS), output
    (b, b) (b a multiple of TILE)."""
    if k <= 0 or k % KS or b <= 0 or b % TILE:
        raise ValueError(f"dot_plan: want K a multiple of {KS} and B of {TILE}; "
                         f"got K = {k}, B = {b}")
    return DotPlan(KS, b // TILE, k // KS)


def operand_shapes(form: str, k: int = K, b: int = B):
    """The shapes of (A, Bv) in `form`."""
    if form not in FORMS:
        raise ValueError(f"dotform_probe: form {form!r} (want one of {FORMS})")
    return {"c0": ((k, b), (k, b)), "std": ((b, k), (k, b)), "dotT": ((b, k), (b, k))}[form]


def product(A, Bv, form: str):
    """One product of `form` in float32 from the bf16-rounded operands."""
    a, b = _bf16(A), _bf16(Bv)
    return a.T @ b if form == "c0" else a @ b if form == "std" else a @ b.T


def sum_products(prods, reps: int):
    """acc = 0; acc += prods[it % len(prods)] for it < reps (float32)."""
    acc = torch.zeros_like(prods[0])
    for it in range(reps):
        acc = acc + prods[it % len(prods)]
    return acc


def dotform_probe_plain(A, Bv, form: str, reps: int):
    """Σ over reps of the form's product (float32, (B, B))."""
    operand_shapes(form)
    return sum_products([product(A, Bv, form)], reps)


def launch_dots(count_as: str, a, Bv, form: str, pattern: str, reps: int, k: int, b: int):
    """The dot kernel of csrc/probes_dots.cu: Σ over reps of the product,
    (b, b) float32, after the caller checked the operands."""
    if k % KS or b % 128 or reps < 0:
        raise ValueError(f"{count_as}: want K a multiple of {KS}, B of 128 and reps >= 0; "
                         f"got K = {k}, B = {b}, reps = {reps}")
    if (a.dtype != torch.bfloat16 or Bv.dtype != torch.bfloat16
            or not (a.is_contiguous() and Bv.is_contiguous())):
        raise ValueError(f"{count_as}: want contiguous bfloat16 operands, got {a.dtype}, "
                         f"{Bv.dtype}")
    dev = a.device
    if dev.type != "cuda" or Bv.device != dev:
        raise ValueError(f"{count_as}: tensors on {dev}, {Bv.device}; the kernel needs CUDA")
    plan = dot_plan(k, b)
    part = torch.empty((plan.slices, b, b), dtype=torch.float32, device=dev)
    out = torch.empty((b, b), dtype=torch.float32, device=dev)
    cuda_lib.launch(count_as, "gpc_dot_probe", a.data_ptr(), Bv.data_ptr(), part.data_ptr(),
                    out.data_ptr(), FORMS.index(form), PATTERNS.index(pattern), k, b, reps,
                    plan.ks, cuda_lib.stream_of(a))
    return out


def dotform_probe(A, Bv, form: str, reps: int):
    """make_kernel(form) on the card: A and Bv bfloat16 in the form's
    shapes (operand_shapes), K a multiple of 256, B of 128.  CPU: the plain
    version."""
    if A.device.type == "cpu":
        return dotform_probe_plain(A, Bv, form, reps)
    sa, sb = tuple(A.shape), tuple(Bv.shape)
    if len(sa) != 2 or len(sb) != 2:
        raise ValueError(f"dotform_probe: want 2-D operands, got {sa}, {sb}")
    k, b = (sa[0], sa[1]) if form == "c0" else (sa[1], sa[0])
    if (sa, sb) != operand_shapes(form, k, b):
        raise ValueError(f"dotform_probe: form {form} wants {operand_shapes(form, k, b)}, "
                         f"got {sa}, {sb}")
    return launch_dots("dotform_probe", A, Bv, form, "hoisted", reps, k, b)


def probe_inputs(dev, k=K, b=B, seed=0):
    """The TPU probe's inputs (tools/tpu_dotform_probe.py:83-87): for each
    form in turn, A then Bv standard normal from numpy's default_rng(seed),
    as bfloat16."""
    rng = np.random.default_rng(seed)
    out = {}
    for form in FORMS:
        sa, sb = operand_shapes(form, k, b)
        out[form] = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16, device=dev)
                          for s in (sa, sb))
    return out


def library_dot(A, Bv, form: str):
    """One torch.matmul (cuBLAS) of the bf16 operands in `form`: the
    yardstick, used nowhere in the port."""
    return {"c0": lambda: torch.matmul(A.mT, Bv), "std": lambda: torch.matmul(A, Bv),
            "dotT": lambda: torch.matmul(A, Bv.mT)}[form]()


def per_dot_us(run, reps, lo=64, hi=REPS):
    """(µs per product by the differential pair (hi − lo products), ms at
    hi): `run(n)` launches the probe for n products."""
    from gpc_tpu_torch.probes import cuda_ms
    t_lo, t_hi = cuda_ms(lambda: run(lo), reps), cuda_ms(lambda: run(hi), reps)
    return (t_hi - t_lo) / (hi - lo) * 1e3, t_hi


def main(argv=None):
    from gpc_tpu_torch.probes import cuda_ms, require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(require_card(), flush=True)
    inp = probe_inputs(torch.device("cuda"))
    flop = 2 * K * B * B
    for form in FORMS:
        A, Bv = inp[form]
        us, ms = per_dot_us(lambda n: dotform_probe(A, Bv, form, n), a.reps)
        lib_us = cuda_ms(lambda: library_dot(A, Bv, form), 20) * 1e3
        print(f"form {form:4s}: {us} us/dot ({flop / us / 1e6} TFLOP/s, "
              f"{flop / BF16_PEAK * 1e6 / us:.1%} of the bf16 bound), {ms} ms at {REPS}; "
              f"torch.matmul {lib_us} us/dot ({flop / lib_us / 1e6} TFLOP/s)", flush=True)


if __name__ == "__main__":
    main()
