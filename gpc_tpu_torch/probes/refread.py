"""K8c: what does re-reading the operand before each dot cost?

Hopper version of tools/tpu_refread_probe.py (kernels :51-85, the call at
:111): the sum over `reps` of the c0 product aᵀ Bv (a, Bv bf16, contraction
K, output (B, B) float32) under four read patterns of a:

  hoisted       a (K, B); each block loads its K-slice into shared memory
                once by TMA and runs every product from there
  read_each     a (K, B); Bv's slice stays resident and every product
                streams a's slice again from device memory (L2) through a
                ring of TMA stages
  reshape_each  a (K / B, B, B), read as (K, B) every product: the same
                bytes under a 3-D index (a rank-3 tensor map)
  dynslot       a (2, K / B, B, B); product it reads slot it mod 2, so two
                8 MB copies of a and Bv make a 24 MB working set

On the TPU the question was whether Mosaic copies a ref's value before a
dot; on the H100 it is whether a block can stream its operands from L2 for
every product (the working set fits the 50 MB L2) or must keep its
K-slice in shared memory, which decides how a redesigned K3 feeds its
correction.  Same kernel as K8b (csrc/probes_dots.cu).  A CPU tensor takes
the plain version.

    python -m gpc_tpu_torch.probes.refread [--reps 3]

times the four patterns on the card at the TPU probe's shapes (K = 8192,
B = 512, REPS = 1024) by differential pairs (1024 and 64 products).  Needs
CUDA.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gpc_tpu_torch.probes.dotform import (BF16_PEAK, PATTERNS, dot_plan, launch_dots,
                                          per_dot_us, product, sum_products)

K, B, REPS = 8192, 512, 1024


def a_shape(pattern: str, k: int = K, b: int = B):
    """The shape of a under `pattern`."""
    if pattern not in PATTERNS:
        raise ValueError(f"refread_probe: pattern {pattern!r} (want one of {PATTERNS})")
    return {"hoisted": (k, b), "read_each": (k, b), "reshape_each": (k // b, b, b),
            "dynslot": (2, k // b, b, b)}[pattern]


def refread_probe_plain(a, Bv, pattern: str, reps: int):
    """Σ over reps of slot(it)ᵀ Bv in float32 from bf16 operands, slot(it)
    = a (as (K, B)), or a[it mod 2] under dynslot."""
    a_shape(pattern)
    k, b = Bv.shape
    slots = a.reshape(-1, k, b)
    return sum_products([product(s, Bv, "c0") for s in slots], reps)


def refread_probe(a, Bv, pattern: str, reps: int):
    """The TPU probe's kernel for `pattern` on the card: a bfloat16 in
    a_shape(pattern), Bv (K, B) bfloat16, K a multiple of 256, B of 128.
    CPU: the plain version."""
    if a.device.type == "cpu":
        return refread_probe_plain(a, Bv, pattern, reps)
    if Bv.dim() != 2 or tuple(a.shape) != a_shape(pattern, *Bv.shape):
        raise ValueError(f"refread_probe: pattern {pattern} wants a "
                         f"{a_shape(pattern, *Bv.shape) if Bv.dim() == 2 else '?'} beside "
                         f"Bv (K, B); got {tuple(a.shape)}, {tuple(Bv.shape)}")
    k, b = Bv.shape
    if k % b:
        raise ValueError(f"refread_probe: K = {k} is not a multiple of B = {b}")
    return launch_dots("refread_probe", a, Bv, "c0", pattern, reps, k, b)


def probe_inputs(dev, k=K, b=B, seed=0):
    """The TPU probe's inputs (tools/tpu_refread_probe.py:102-105) from
    numpy's default_rng(seed), in its order, as bfloat16: a per pattern
    (hoisted and read_each share the (K, B) one) and Bv."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=dev)
    a2, a3, a4, Bv = t((k, b)), t((k // b, b, b)), t((2, k // b, b, b)), t((k, b))
    return dict(hoisted=a2, read_each=a2, reshape_each=a3, dynslot=a4), Bv


def main(argv=None):
    from gpc_tpu_torch.probes import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(require_card(), flush=True)
    a, Bv = probe_inputs(torch.device("cuda"))
    flop = 2 * K * B * B
    l2 = dot_plan(K, B).streamed_bytes
    for pattern in PATTERNS:
        us, ms = per_dot_us(lambda n: refread_probe(a[pattern], Bv, pattern, n), args.reps)
        print(f"{pattern:13s} {us} us/dot ({flop / us / 1e6} TFLOP/s, "
              f"{flop / BF16_PEAK * 1e6 / us:.1%} of the bf16 bound), {ms} ms at {REPS}"
              + ("" if pattern == "hoisted" else f"; L2 bytes of a a product {l2}"), flush=True)


if __name__ == "__main__":
    main()
