"""Hopper probes: kernels that answer design questions, on no model path.

`chol_mega` (K7) is the whole rbf evidence in one persistent launch, against
K3's per-panel launches; `overlap` (K8a) measures whether leaves hide under
the Schur GEMMs, the slab stream rate and the cost of a leaf's parts;
`dotform` (K8b) times the three operand layouts of a chained bf16 product,
`refread` (K8c) the same product with its operand re-read before each dot
in four patterns, and `vpu` (K8d) the epilogue-side rates: an exp tile, an
rbf Gram tile, a serial matvec chain and a staged bf16 store.  Each kernel
has a plain PyTorch version that computes the same returned values;
`python -m gpc_tpu_torch.probes.<name>` times them on the card.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back to float32: the kernels' GEMM inputs."""
    return x.to(torch.bfloat16).float()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` in ms over `reps` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, rounds: int = 3) -> float:
    """Device time of `fn` in ms a call: `calls` calls captured in one CUDA
    graph, the fastest of `rounds` replays (CUDA events).  No host work
    between the launches, so a call shorter than its host path is timed
    alone, which cuda_ms cannot do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                      # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def require_card() -> str:
    """The card's name and power limit as nvidia-smi gives them; exits
    non-zero without a CUDA device (nothing here measures on the CPU)."""
    if not torch.cuda.is_available():
        print(f"{sys.argv[0]}: no CUDA device", file=sys.stderr)
        sys.exit(2)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
