"""Finding a cell's parts by the names in BENCHMARK.json.

Whatever belongs to one configuration, traffic mix, metric or cell sits in
files of its own, found by name under the benchmark's folder:

  configs/  the configuration's file, named in BENCHMARK.json (`file`);
  traffic/<traffic>.json  the mix's parameters, read by the driver that
            its `kind` names (harness/<kind>.py);
  metrics/<metric>.py     a reader: read(run) → a number, or None where
            the run holds nothing for it to read;
  limits/<workload>.json  the limit of each number that `correct` compares;
  systems/<system>.py     how the configuration drives the program;
  reference/<reference>.py  the configuration's plain reference.

A later cell, mix or metric is new files and new entries; no file that is
there needs an edit."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

FOLDER = "benchmark"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(root: Path, kind: str, name: str):
    """The Python file <root>/benchmark/<kind>/<name>.py, loaded once per
    process under a module name of its own."""
    path = Path(root) / FOLDER / kind / f"{name}.py"
    mod_name = f"_bench_{kind}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules and getattr(sys.modules[mod_name], "__file__", None) == str(path):
        return sys.modules[mod_name]
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of `workloads` with everything found by its names."""

    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, and those without a
        `workloads` key, which every cell reporting what they move reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def reader(self, metric: str):
        return module(self.root, "metrics", metric)

    def system(self):
        return module(self.root, "systems", self.config["system"])

    def reference(self):
        return module(self.root, "reference", self.config["reference"])

    def driver(self):
        return module(self.root, "harness", self.traffic["kind"])


def load_cell(root: Path, workload: str, overrides: dict | None = None) -> Cell:
    """The cell `workload` of <root>/BENCHMARK.json.  `overrides` replace
    keys of the configuration and the traffic (the CPU tests' small sizes)."""
    root = Path(root)
    bench = read_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    wl = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(root / FOLDER / "traffic" / f"{wl['traffic']}.json")
    limits = read_json(root / FOLDER / "limits" / f"{workload}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(root=root, bench=bench, workload=wl, config=config, traffic=traffic,
                limits=limits)


@dataclass
class Run:
    """What one run recorded, for the metric readers.  Times are host
    seconds (time.perf_counter); `trace` is the traced part, or None."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    evals: list = field(default_factory=list)       # training: (t0, t1)
    segments: list = field(default_factory=list)    # training: (t0, t1, iterations, evaluations)
    requests: list = field(default_factory=list)    # serving: (due, start, end, rows)
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config
