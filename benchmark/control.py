"""The readings that the limits of `correct` are set from, in one process.

    python benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 \
        [--variants program,control,half,altered,frozen] [--out FILE]

For each seed and variant, one run of the cell (run.measure, tracing off)
with the system under test replaced as the variant says:

  program  the program itself: sound runs, the lower reading of each number;
  control  the precision control (systems/gp_control.py): the plain
           reference one precision step below the configuration's, in the
           program's place: the upper reading;
  half, altered, frozen  a fault planted under the harness
           (systems/gp_faults.py).

Prints one JSON line a run: the variant, the seed, `correct` under the
cell's limits and every number compared.  The benchmark's own runs never
run this.  Needs the card, as run.py does."""

from __future__ import annotations

import argparse
import json
import sys
import time

import run
from harness import spec

SYSTEMS = {"program": None, "control": "gp_control", "half": "gp_faults",
           "altered": "gp_faults", "frozen": "gp_faults"}


def overrides(variant: str) -> dict:
    system = SYSTEMS[variant]
    if system is None:
        return {}
    cfg = {"system": system}
    if system == "gp_faults":
        cfg["fault"] = variant
    return {"config": cfg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variants", default="program,control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        for variant in args.variants.split(","):
            cell = spec.load_cell(run.ROOT, args.workload, overrides(variant))
            t0 = time.perf_counter()
            res = run.measure(cell, seed, args.seconds, False, "cuda")
            line = json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                               "correct": res["correct"], "attempted": res["attempted"],
                               "failed": res["failed"], "checks": res["checks"],
                               "seconds": time.perf_counter() - t0})
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
