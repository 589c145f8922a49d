"""K8d: the epilogue-side rates beside the GEMMs — exp, a Gram tile, a
serial matvec chain and a staged bf16 store.

Hopper versions of the four kernels of tools/tpu_vpu_probe.py (design and
bounds in csrc/probes_vpu.cu):

  vpu_exp          kern_exp (:37-42, call :114): acc ← 0.5 acc +
                   exp(−(A + 1e-9 acc)), `reps` times, A (B, B) f32
  vpu_gram_tile    kern_gramtile (:45-54, call :121): acc ← exp(−max(n2 +
                   n2ᵀ − 2 XXᵀ + 1e-9 acc[0, 0], 0)), X (B, 8) f32, XXᵀ
                   formed every rep (on the tensor cores, X split into
                   two tf32 halves)
  vpu_matvec       kern_matvec (:57-65, call :128): v ← (Aᵀv) / (1 +
                   |(Aᵀv)₀|), `reps` times, v (B, 1); one thread-block
                   cluster, A on chip
  vpu_stage_store  kern_store_dma (:68-87, call :134): n times, stage
                   bf16(A + 1e-9 it) and copy it to big[it mod 64]; returns
                   big (64, B, B) bf16 and o (B, B) = n.  mode "bulk" copies
                   8 KiB at a time by cp.async.bulk from each warp's ring
                   of stages in shared memory, "direct" stores 16 bytes a
                   thread; store_plan splits the work among warps.  Slots
                   that no iteration reaches (n < 64) are left unwritten.

Each has a plain PyTorch version that computes the same values; a CPU
tensor takes it.

    python -m gpc_tpu_torch.probes.vpu

times them on the card at the TPU probe's shapes (B = 512, REPS = 2048;
1024 iterations for the matvec and the store), 10 calls captured in a CUDA
graph, and prints µs per iteration by differential pairs; probes/vpu_turns.py
times the kernels of several checkouts (a parent, a variant) in turns by one
method.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib

B, REPS = 512, 2048
D = 8          # the Gram tile's input width
SLOTS = 64     # big's slots
MODES = ("bulk", "direct")


def _check(name: str, shape_ok: bool, want: str, *tensors):
    """A wrapper's checks, shapes first, then float32, then CUDA and
    contiguity: ValueError on what the kernel does not take."""
    if not shape_ok:
        raise ValueError(f"{name}: want {want}; got {[tuple(t.shape) for t in tensors]}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel needs float32")
    cuda_lib.require_cuda(name, *tensors)
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")


def _square(A, b_ok) -> bool:
    return A.dim() == 2 and A.shape[0] == A.shape[1] and b_ok(A.shape[0])


# ---------------------------------------------------------------------------
# exp
# ---------------------------------------------------------------------------

def vpu_exp_plain(A, reps: int):
    acc = torch.zeros_like(A)
    for _ in range(reps):
        acc = acc * 0.5 + torch.exp(-(A + acc * 1e-9))
    return acc


def vpu_exp(A, reps: int):
    """kern_exp on the card: A (B, B) float32, any B.  CPU: the plain
    version."""
    if A.device.type == "cpu":
        return vpu_exp_plain(A, reps)
    _check("vpu_exp", _square(A, lambda b: b > 0), "A (B, B)", A)
    out = torch.empty_like(A)
    cuda_lib.launch("vpu_exp", "gpc_vpu_exp", A.data_ptr(), out.data_ptr(), A.numel(), reps,
                    cuda_lib.stream_of(A))
    return out


# ---------------------------------------------------------------------------
# the rbf Gram tile
# ---------------------------------------------------------------------------

def vpu_gram_tile_plain(X, n2, reps: int):
    """X (B, 8), n2 (B, 1) = row sums of X²; XXᵀ in float32 every rep."""
    b = X.shape[0]
    n2r = n2.reshape(1, b)
    acc = torch.zeros((b, b), dtype=X.dtype, device=X.device)
    for _ in range(reps):
        G = X @ X.T
        d2 = torch.clamp_min(n2 + n2r - 2.0 * G + acc[0:1, 0:1] * 1e-9, 0.0)
        acc = acc * 0.0 + torch.exp(-d2)
    return acc


def vpu_gram_tile(X, n2, reps: int):
    """kern_gramtile on the card: X (B, 8) and n2 (B, 1) float32, B a
    multiple of 64.  CPU: the plain version."""
    if X.device.type == "cpu":
        return vpu_gram_tile_plain(X, n2, reps)
    b = X.shape[0]
    _check("vpu_gram_tile", X.dim() == 2 and X.shape[1] == D and b % 64 == 0
           and tuple(n2.shape) == (b, 1), f"X (B, {D}) and n2 (B, 1), B a multiple of 64", X, n2)
    out = torch.empty((b, b), dtype=torch.float32, device=X.device)
    cuda_lib.launch("vpu_gram_tile", "gpc_vpu_gram", X.data_ptr(), n2.data_ptr(),
                    out.data_ptr(), b, reps, cuda_lib.stream_of(X))
    return out


# ---------------------------------------------------------------------------
# the D = 1 matvec chain
# ---------------------------------------------------------------------------

def vpu_matvec_plain(A, v, reps: int):
    for _ in range(reps):
        p = A.T @ v
        v = p * (1.0 / (1.0 + p[0:1, 0:1].abs()))
    return v


def matvec_cluster(b: int = B) -> int:
    """The matvec's cluster size on this card at width b: 16 where a
    cluster of 16 of its blocks fits (the non-portable size), else 8."""
    cs = cuda_lib.library().gpc_vpu_matvec_cluster(b)
    if cs not in (8, 16):
        raise RuntimeError(f"vpu_matvec: no cluster of 8 or 16 blocks fits at B = {b}")
    return cs


MATVEC_HOMES = ("registers", "shared memory", "L2, streamed every step")


def matvec_home(b: int, cs: int) -> str:
    """Where each block of the matvec keeps its b/cs columns of A: in
    registers (32 entries a thread at most), in shared memory (160 KB at
    most) or read from L2 every step (csrc/probes_vpu.cu's mv_home)."""
    return MATVEC_HOMES[cuda_lib.library().gpc_vpu_matvec_home(b, cs)]


def vpu_matvec(A, v, reps: int, *, _cluster: int | None = None):
    """kern_matvec on the card (one launch of a cluster of matvec_cluster's
    size; `_cluster`, 8 or 16, forces one, for the timings): A (B, B) and v
    (B, 1) float32, B a power of two from 64 to 1024.  CPU: the plain
    version."""
    if A.device.type == "cpu":
        return vpu_matvec_plain(A, v, reps)
    b = A.shape[0]
    _check("vpu_matvec", _square(A, lambda n: 64 <= n <= 1024 and n & (n - 1) == 0)
           and tuple(v.shape) == (b, 1), "A (B, B) and v (B, 1), B a power of two in [64, 1024]",
           A, v)
    cs = matvec_cluster(b) if _cluster is None else _cluster
    if cs not in (8, 16):
        raise ValueError(f"vpu_matvec: cluster {cs} (want 8 or 16)")
    out = torch.empty_like(v)
    cuda_lib.launch("vpu_matvec", "gpc_vpu_matvec", A.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, reps, cs, cuda_lib.stream_of(A))
    return out


# ---------------------------------------------------------------------------
# the staged bf16 store
# ---------------------------------------------------------------------------

STORE_CHUNK = 4096      # bf16 values a warp owns and copies at once (8 KiB)
STORE_WARPS = 4         # warps of a block
STORE_MAX_CLASSES = 8   # a slot's copies lie 64 / classes >= 8 of a warp's copies apart


class StorePlan(NamedTuple):
    """The staged store's split of one call: the flattened (B, B) tile in
    `chunks` pieces of STORE_CHUNK values, the iterations in `classes`
    residue classes mod `classes` (a divisor of 64).  Warp chunk + chunks ·
    cls copies its chunk for iterations cls, cls + classes, ... in that
    order; blocks of STORE_WARPS warps."""
    chunks: int
    classes: int

    @property
    def warps(self) -> int:
        return self.chunks * self.classes

    @property
    def blocks(self) -> int:
        return self.warps // STORE_WARPS


def store_plan(b: int, sms: int) -> StorePlan:
    """The split at width b (a multiple of 128 up to 1024) on a card of
    `sms` SMs: the most iteration classes (up to STORE_MAX_CLASSES) whose
    blocks, one an SM, still fit in one wave."""
    if b <= 0 or b % 128 or b > 1024 or sms <= 0:
        raise ValueError(f"store_plan: want B a multiple of 128 up to 1024 and sms > 0; "
                         f"got B = {b}, sms = {sms}")
    chunks = b * b // STORE_CHUNK
    classes = 1
    while classes < STORE_MAX_CLASSES and chunks * classes * 2 // STORE_WARPS <= sms:
        classes *= 2
    return StorePlan(chunks, classes)


@functools.lru_cache(maxsize=None)
def _store_classes(b: int, device_index: int) -> int:
    """store_plan's classes at width b on card `device_index`, once per
    pair; the first call also holds STORE_CHUNK, STORE_WARPS and
    STORE_MAX_CLASSES against the kernel's own (gpc_vpu_store_layout)."""
    layout = (ctypes.c_int * 3)()
    cuda_lib.library().gpc_vpu_store_layout(layout)
    if tuple(layout) != (STORE_CHUNK, STORE_WARPS, STORE_MAX_CLASSES):
        raise RuntimeError(f"vpu_stage_store: the kernel's (chunk, warps, max classes) "
                           f"{tuple(layout)} differ from store_plan's "
                           f"{(STORE_CHUNK, STORE_WARPS, STORE_MAX_CLASSES)}")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return store_plan(b, sms).classes


def written_slots(n_iters: int) -> int:
    """Slots of big that n iterations write: 0 .. min(n, 64) − 1."""
    return min(n_iters, SLOTS)


def vpu_stage_store_plain(A, n_iters: int):
    """(big, o): big[s] = bf16(A + 1e-9 it) for the last it < n with it mod
    64 = s (float32 sums, unfused), zeros where no iteration writes; o (B,
    B) = n."""
    b = A.shape[0]
    big = torch.zeros((SLOTS, b, b), dtype=torch.bfloat16, device=A.device)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=A.device)
    for it in range(max(0, n_iters - SLOTS), n_iters):
        s = torch.tensor(float(it), dtype=torch.float32, device=A.device) * eps
        big[it % SLOTS] = (A + s).to(torch.bfloat16)
    return big, torch.full((b, b), float(n_iters), dtype=torch.float32, device=A.device)


def vpu_stage_store(A, n_iters: int, mode: str = "bulk"):
    """kern_store_dma on the card: A (B, B) float32, B a multiple of 128 up
    to 1024; big is allocated here and only its written slots are defined.
    CPU: the plain version (unwritten slots zero)."""
    if mode not in MODES:
        raise ValueError(f"vpu_stage_store: mode {mode!r} (want one of {MODES})")
    if A.device.type == "cpu":
        return vpu_stage_store_plain(A, n_iters)
    _check("vpu_stage_store", _square(A, lambda n: n % 128 == 0 and n <= 1024),
           "A (B, B), B a multiple of 128 up to 1024", A)
    b = A.shape[0]
    classes = _store_classes(b, A.device.index)
    big = torch.empty((SLOTS, b, b), dtype=torch.bfloat16, device=A.device)
    o = torch.empty((b, b), dtype=torch.float32, device=A.device)
    cuda_lib.launch("vpu_stage_store", "gpc_vpu_store", A.data_ptr(), big.data_ptr(),
                    o.data_ptr(), b, n_iters, classes, int(mode == "bulk"),
                    cuda_lib.stream_of(A))
    return big, o


# ---------------------------------------------------------------------------
# inputs and timings on the card
# ---------------------------------------------------------------------------

def probe_inputs(dev, b=B, seed=0):
    """The TPU probe's inputs (tools/tpu_vpu_probe.py:104, 119-120, 127)
    from numpy's default_rng(seed), in its order: A (B, B), X (B, 8) with
    n2 = row sums of X², v (B, 1), all float32."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, b)).astype(np.float32)
    X = rng.standard_normal((b, D)).astype(np.float32)
    n2 = np.sum(X * X, axis=1, keepdims=True)
    v = rng.standard_normal((b, 1)).astype(np.float32)
    return {k: torch.tensor(x, device=dev) for k, x in dict(A=A, X=X, n2=n2, v=v).items()}


def runs(inp):
    """name → (fn(n) launching the kernel for n iterations, full n)."""
    A, X, n2, v = inp["A"], inp["X"], inp["n2"], inp["v"]
    return {"exp": (lambda n: vpu_exp(A, n), REPS),
            "gram": (lambda n: vpu_gram_tile(X, n2, n), REPS),
            "matvec": (lambda n: vpu_matvec(A, v, n), REPS // 2),
            "store-bulk": (lambda n: vpu_stage_store(A, n, "bulk"), REPS // 2),
            "store-direct": (lambda n: vpu_stage_store(A, n, "direct"), REPS // 2)}


def main(argv=None):
    from gpc_tpu_torch.probes import graph_ms, require_card
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    print(require_card(), flush=True)
    dev = torch.device("cuda")
    cs = matvec_cluster(B)
    plan = store_plan(B, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"matvec: one cluster of {cs} blocks, A in {matvec_home(B, cs)}; store: "
          f"{plan.chunks} chunks x {plan.classes} classes, {plan.blocks} blocks", flush=True)
    for name, (fn, n) in runs(probe_inputs(dev)).items():
        t_lo, t_hi = (graph_ms(lambda m=m: fn(m), calls=10) for m in (n // 8, n))
        per = (t_hi - t_lo) / (n - n // 8) * 1e3
        extra = (f", {B * B * 2 / per / 1e6} TB/s written" if name.startswith("store") else "")
        print(f"{name:13s} {per} us/iter (differential), {t_hi} ms at {n}{extra}", flush=True)


if __name__ == "__main__":
    main()
