"""One run of an open-loop serving cell, with the anatomy of its latencies.

    python3 benchmark/serve_runs.py --workload <name> --seed <n> --seconds 30 [--rate R]

Runs the cell once as run.py does with --trace 0 (run.measure and
run.report: the same set-up, window, check and import guard), offered at
the traffic file's rate or at --rate, prints run.py's result line, then
one JSON line of sweep.py's summary of the run's requests: p50_ms and
p95_ms are the cell's serve_p50_ms and serve_p95_ms, service_ms its
serve.call_ms.serve, wait_ms its serve.wait_ms.serve, and waited_share,
small_free_p50_ms and small_service_ms split them into what moves them.
Where run.report refuses the run, it prints neither line.

The benchmark's own runs never run this: it is for re-rating a serving
cell's rate and bounds.  Needs the card, as run.py does."""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402
import sweep  # noqa: E402
from harness import spec  # noqa: E402


def one(cell, seed: int, seconds: float, device: str = "cuda",
        t_proc: float | None = None) -> int:
    """Run the cell once and print its two lines; run.report's return code."""
    record = spec.Run(cell=cell)
    result = run.measure(cell, seed, seconds, False, device, t_proc, record)
    rc = run.report(result, "serve_runs.py")
    if rc == 0:
        line = {"workload": cell.name, "seed": seed, "correct": result["correct"],
                **sweep.summary(float(cell.traffic["rate"]), record.requests)}
        print(json.dumps(line), flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("serve_runs.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    ov = {"traffic": {"rate": args.rate}} if args.rate is not None else None
    return one(spec.load_cell(run.ROOT, args.workload, ov), args.seed, args.seconds,
               "cuda", T_PROC)


if __name__ == "__main__":
    sys.exit(main())
