"""The knee sweep of an open-loop serving cell, once, on the card.

    python benchmark/sweep.py --workload <name> --seed <n> --seconds 10 --rates 40,60,80

Builds the cell's set-up once (harness/open_loop.prepare), then for each
rate serves the cell's mix offered at that rate for --seconds and prints
one JSON line: the rate, the requests, the median and 95th-percentile
latency, the mean wait before a call started, the growth of that wait
(the mean over the last quarter of the requests less that over the
first), the backlog at the close (requests due by the last arrival
and not finished then), the mean wall of a call, and what splits the
latencies: the share of requests that found the server busy (the
previous request ended after this one was due, so that its call started
late), the median latency of the requests of at most SMALL_ROWS rows that
did not wait, and the median wall of a call of at most SMALL_ROWS rows.
The knee is the highest rate at which the backlog does not grow through
the window; a cell runs at about four fifths of it, written into its
traffic file as a number."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import run
from harness import open_loop, spec


SMALL_ROWS = 128


def summary(rate: float, out: list) -> dict:
    """The line of one rate from the served [(due, start, end, rows)]."""
    due, start, end, rows = (np.array(c, dtype=np.float64) for c in zip(*out))
    lat = (end - due) * 1e3
    wait = (start - due) * 1e3
    call = (end - start) * 1e3
    waited = np.concatenate([[False], end[:-1] > due[1:]])
    small = rows <= SMALL_ROWS
    free_small = lat[small & ~waited]
    q = max(1, len(out) // 4)
    return {"rate": rate, "requests": len(out),
            "p50_ms": float(np.median(lat)), "p95_ms": float(np.percentile(lat, 95)),
            "wait_ms": float(wait.mean()),
            "wait_growth_ms": float(wait[-q:].mean() - wait[:q].mean()),
            "backlog_at_close": int(np.sum(end > due[-1])),
            "service_ms": float(call.mean()),
            "waited_share": float(waited.mean()),
            "small_free_p50_ms": float(np.median(free_small)) if free_small.size else None,
            "small_service_ms": float(np.median(call[small])) if small.any() else None}


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
