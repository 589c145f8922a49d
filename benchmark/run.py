"""Run one cell of the benchmark of gpc_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's configuration, traffic mix, metric readers and limits by
the names in BENCHMARK.json (harness/spec.py), runs the traffic kind's
driver on the card for a window of --seconds, judges what the window
produced against the plain float64 reference, and prints as the last line
of standard output one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), device, with --trace 1 a breakdown of the traced part, and last
the numbers compared beside their limits (`checks`), which also end
standard error.  Needs as many CUDA devices as the cell asks for: without
them it exits non-zero and prints no result.  It also exits non-zero, with
no result, when JAX or the JAX package gpc_tpu has been loaded, or when
the plain reference imports the program.

Caches: the program builds its kernels into gpc_tpu_torch/_build/ inside
the checkout, so a checkout's first run builds and the next ones load."""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard, judge, spec  # noqa: E402

# One process with few threads keeps the host's share of a run steady: the
# program's host work is Python and launches, and idle intra-op threads
# only add wake-ups.
THREADS = 1


def device_info(device: str, chips: int, peak_bytes: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_proc: float | None = None, run: spec.Run | None = None) -> dict:
    """Run the cell once and return the result object (not printed).  A
    caller that reads the run's records itself passes the spec.Run to fill."""
    run = spec.Run(cell=cell) if run is None else run
    outcome = cell.driver().run(cell, seed, seconds, trace, device,
                                time.perf_counter() if t_proc is None else t_proc, run)
    correct, table = judge.judge(outcome, cell.limits)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_info(device, cell.workload["chips"], run.peak_bytes)}
    if trace and run.trace is not None:
        t = run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps("harness")}
        result["trace_file_bytes"] = t.file_bytes
    # a number that is not finite is printed as text: strict JSON has no inf
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else repr(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def report(result: dict, prog: str = "run.py") -> int:
    """After the window: where the import guard finds a fault, name it on
    standard error, print no result and return 3; else end standard error
    with the numbers compared beside their limits, print the result line
    and return 0."""
    faults = guard.check(HERE / "reference")
    if faults:
        for f in faults:
            print(f"{prog}: import guard: {f}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell of gpc_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(THREADS)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    return report(measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROC))


if __name__ == "__main__":
    sys.exit(main())
