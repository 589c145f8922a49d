"""K8d's kernels of several checkouts, timed in turns by one method.

    python -m gpc_tpu_torch.probes.vpu_turns ROOT [ROOT ...] [--rounds 2]

Each ROOT is a directory that holds a `gpc_tpu_torch/` package: this
checkout, its parent unpacked by `git archive`, or a variant of either.
Every root's kernels are built first.  Then, round by round, the roots take
turns (forward in even rounds, backward in odd ones: A B B A for two roots
and two rounds).  In each turn a child process imports `gpc_tpu_torch` from
that root alone and times its K8d runs (`probes.vpu.runs`, B = 512) with
this file's timer, the same for every root: n / 8 and n iterations, 10
calls captured in one CUDA graph, the fastest of 3 replays, and µs an
iteration by the differential pair; the full count also eager, 3 calls back
to back.  It then holds each result at the full count against the root's
plain version: the largest error over the plain tile's largest entry (exp,
the Gram tile, the matvec chain), and whether the 64 slots and o of both
store modes are equal bit for bit.

Each turn prints one JSON line (`TURN {...}`, with the sha-256 of the root's
`csrc/probes_vpu.cu`); the last lines give, for each root and kernel, the
graph times of all its turns.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

GRAPH_CALLS, GRAPH_ROUNDS, EAGER_CALLS = 10, 3, 3


def graph_ms(fn, calls=GRAPH_CALLS, rounds=GRAPH_ROUNDS):
    """ms a call: `calls` calls captured in one CUDA graph, the fastest of
    `rounds` replays (CUDA events), after a warm-up outside the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def eager_ms(fn, calls=EAGER_CALLS):
    """Mean ms of `calls` eager calls back to back, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def child(root: str, build_only: bool) -> dict:
    """One turn in this process: gpc_tpu_torch imported from `root`."""
    sys.path[0] = os.path.abspath(root)   # in place of this file's directory
    import torch

    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.probes import vpu
    assert os.path.abspath(vpu.__file__).startswith(os.path.abspath(root) + os.sep)
    cuda_lib.library()
    src = (cuda_lib.CSRC / "probes_vpu.cu").read_bytes()
    turn = {"root": root, "probes_vpu_sha256": hashlib.sha256(src).hexdigest()[:16],
            "build_s": cuda_lib.build_seconds}
    if build_only:
        return turn
    inp = vpu.probe_inputs(torch.device("cuda"))
    runs = vpu.runs(inp)
    turn.update(graph_ms={}, us_per_iter={}, eager_ms={})
    for name, (fn, n) in runs.items():
        lo, hi = (graph_ms(lambda m=m: fn(m)) for m in (n // 8, n))
        turn["graph_ms"][name] = hi
        turn["us_per_iter"][name] = (hi - lo) / (n - n // 8) * 1e3
        turn["eager_ms"][name] = eager_ms(lambda: fn(n))
    A, X, n2, v = inp["A"], inp["X"], inp["n2"], inp["v"]
    turn["rel_err"] = {
        "exp": _rel_err(vpu.vpu_exp(A, vpu.REPS), vpu.vpu_exp_plain(A, vpu.REPS)),
        "gram": _rel_err(vpu.vpu_gram_tile(X, n2, vpu.REPS),
                         vpu.vpu_gram_tile_plain(X, n2, vpu.REPS)),
        "matvec": _rel_err(vpu.vpu_matvec(A, v, vpu.REPS // 2),
                           vpu.vpu_matvec_plain(A, v, vpu.REPS // 2))}
    big_p, o_p = vpu.vpu_stage_store_plain(A, vpu.REPS // 2)
    for mode in vpu.MODES:
        big, o = vpu.vpu_stage_store(A, vpu.REPS // 2, mode)
        turn[f"store_{mode}_equal"] = bool(torch.equal(big, big_p) and torch.equal(o, o_p))
    torch.cuda.synchronize()
    return turn


def _spawn(root: str, *flags: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, *flags],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed (rc {out.returncode}):\n"
                           f"{out.stdout[-4000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(child(a.roots[0], a.build_only)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        print(f"{sys.argv[0]}: no CUDA device", file=sys.stderr)
        sys.exit(2)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in a.roots:
        print(f"BUILD {json.dumps(_spawn(root, '--build-only'))}", flush=True)
    turns = []
    for r in range(a.rounds):
        for root in (a.roots if r % 2 == 0 else a.roots[::-1]):
            t = dict(_spawn(root), round=r)
            turns.append(t)
            print(f"TURN {json.dumps(t)}", flush=True)
    for root in a.roots:
        mine = [t for t in turns if t["root"] == root]
        for name in mine[0]["graph_ms"]:
            print(f"{root} {name}: graph ms {[t['graph_ms'][name] for t in mine]}, "
                  f"us/iter {[t['us_per_iter'][name] for t in mine]}, "
                  f"eager ms {[t['eager_ms'][name] for t in mine]}", flush=True)


if __name__ == "__main__":
    main()
