"""The knee sweep of an open-loop serving cell, once, on the card.

    python benchmark/sweep.py --workload <name> --seed <n> --seconds 10 --rates 40,60,80

Builds the cell's set-up once (harness/open_loop.prepare), then for each
rate serves the cell's mix offered at that rate for --seconds and prints
one JSON line: the rate, the requests, the median and 95th-percentile
latency, the mean wait before a call started, the growth of that wait
(the mean over the last quarter of the requests less that over the
first), and the backlog at the close (requests due by the last arrival
and not finished then).  The knee is the highest rate at which the
backlog does not grow through the window; a cell runs at about four
fifths of it, written into its traffic file as a number."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import run
from harness import open_loop, spec


def summary(rate: float, out: list) -> dict:
    due = np.array([d for d, _, _, _ in out])
    start = np.array([s for _, s, _, _ in out])
    end = np.array([e for _, _, e, _ in out])
    lat = (end - due) * 1e3
    wait = (start - due) * 1e3
    q = max(1, len(out) // 4)
    return {"rate": rate, "requests": len(out),
            "p50_ms": float(np.median(lat)), "p95_ms": float(np.percentile(lat, 95)),
            "wait_ms": float(wait.mean()),
            "wait_growth_ms": float(wait[-q:].mean() - wait[:q].mean()),
            "backlog_at_close": int(np.sum(end > due[-1])),
            "service_ms": float(((end - start) * 1e3).mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    cell = spec.load_cell(run.ROOT, args.workload)
    state = open_loop.prepare(cell, args.seed, "cuda", trace=False)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "seed": args.seed, "seconds": args.seconds}), flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        due, rows, offsets = open_loop.schedule(args.seed, cell.traffic, args.seconds, rate)
        out, _, unserved = open_loop.serve(state, due, rows, offsets)
        line = summary(rate, out)
        line["unserved"] = unserved
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
