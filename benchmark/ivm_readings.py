"""The readings that the limits of `correct` of an `ivm` cell are set from,
in one process.

    python benchmark/ivm_readings.py --workload <name> --seeds 101,102 --seconds 5 \
        [--variants program,control,stale,half,swap,frozen] [--out FILE]

For each seed and variant, one run of the cell (run.measure, tracing off)
with the system under test replaced as the variant says:

  program  the program itself: sound runs, the lower reading of each number;
  control  the precision control (systems/ivm_control.py): the plain
           reference one precision step below the configuration's, in the
           program's place;
  stale, half, swap, frozen  a fault planted under the harness
           (systems/ivm_faults.py).

Prints one JSON line a run: the variant, the seed, `correct` under the
cell's limits and every number the traffic kind compared, limited or not.  The
benchmark's own runs never run this.  Needs the card, as run.py does."""

from __future__ import annotations

import argparse
import json
import sys
import time

import run
from harness import judge, spec

SYSTEMS = {"program": None, "control": "ivm_control", "stale": "ivm_faults",
           "half": "ivm_faults", "swap": "ivm_faults", "frozen": "ivm_faults"}


def overrides(variant: str) -> dict:
    system = SYSTEMS[variant]
    if system is None:
        return {}
    cfg = {"system": system}
    if system == "ivm_faults":
        cfg["fault"] = variant
    return {"config": cfg}


def reading(cell, seed: int, seconds: float, device: str) -> dict:
    """One run's `correct` and every number its traffic kind compared."""
    r = spec.Run(cell=cell)
    outcome = cell.driver().run(cell, seed, seconds, False, device, time.perf_counter(), r)
    correct, _ = judge.judge(outcome, cell.limits)
    return {"correct": bool(correct), "attempted": outcome.attempted,
            "failed": outcome.failed, "checks": {k: repr(v) for k, v in outcome.checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variants", default="program,control,stale,half,swap,frozen")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ivm_readings.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        for variant in args.variants.split(","):
            cell = spec.load_cell(run.ROOT, args.workload, overrides(variant))
            t0 = time.perf_counter()
            res = reading(cell, seed, args.seconds, "cuda")
            line = json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                               **res, "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
