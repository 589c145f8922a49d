"""The harness on the CPU at small sizes, each cell at its system's
(conftest.py): cells found by name, each cell's run correct with the
committed limits, the contract's shape of BENCHMARK.json, and `correct`
false under the cell's precision control and under each fault the cell
can have.  One test runs a cell on the card."""

import json
import re
import subprocess
import sys

import pytest

import run
from harness import spec
from conftest import BENCH, CONTROL, IVM_SMALL, ROOT, SMALL

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
LOADED = {w: spec.load_cell(ROOT, w) for w in CELLS}
# The sizes a CPU test holds, for the cell's run and for its control, by system.
SIZES = {"gp": (SMALL, CONTROL), "ivm": (IVM_SMALL, IVM_SMALL)}
# The faults that each traffic kind's cell can have (systems/<system>_faults.py).
FAULTS = {"scg_segments": ("frozen", "half", "altered"), "open_loop": ("half", "altered"),
          "ivm_rounds": ("stale", "half", "frozen")}


def _measure(workload, variant=None, trace=False, seed=2 ** 31 + 11):
    """The cell once at its system's small size, with the system under test
    replaced by its control or a fault where `variant` says so."""
    system = LOADED[workload].config["system"]
    small, control = SIZES[system]
    size = control if variant == "control" else small
    ov = {"config": dict(size["config"]), "traffic": dict(size["traffic"])}
    if variant == "control":
        ov["config"]["system"] = f"{system}_control"
    elif variant:
        ov["config"].update(system=f"{system}_faults", fault=variant)
    return run.measure(spec.load_cell(ROOT, workload, ov), seed, 0.4, trace, "cpu")


def test_the_harness_finds_a_throwaway_configuration_mix_and_metric_by_name(tmp_path):
    b = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics", "limits", "harness"):
        (b / d).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toy", "file": "benchmark/configs/toy.json"}],
        "workloads": [{"name": "toy.mix", "config": "toy", "traffic": "mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s"}, {"name": "work_s", "workloads": ["toy.mix"]}],
        "per_layer": [{"name": "toy_share", "moves": "work_s"},
                      {"name": "other", "moves": "absent_s"}]}))
    (b / "configs" / "toy.json").write_text('{"size": 3}')
    (b / "traffic" / "mix.json").write_text('{"kind": "toy_kind", "rate": 2}')
    (b / "limits" / "toy.mix.json").write_text('{"gap": 0.5}')
    (b / "metrics" / "toy_share.py").write_text("def read(run):\n    return 7.0\n")
    (b / "harness" / "toy_kind.py").write_text("KIND = 'found'\n")
    cell = spec.load_cell(tmp_path, "toy.mix")
    assert cell.config == {"size": 3} and cell.traffic["rate"] == 2
    assert cell.limits == {"gap": 0.5} and cell.driver().KIND == "found"
    assert [m["name"] for m in cell.metrics(False)] == ["setup_s", "work_s"]
    assert [m["name"] for m in cell.metrics(True)] == ["toy_share"]
    assert cell.reader("toy_share").read(None) == 7.0
    with pytest.raises(FileNotFoundError):
        cell.reader("missing")


def test_benchmark_json_keeps_to_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    secs = b["run_seconds"]
    assert 1 <= secs <= 51 and (2 + 14 * 24) * (secs + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = []
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        cell = spec.load_cell(ROOT, w["name"])
        reported = [m["name"] for m in cell.metrics(False)]
        assert "setup_s" in reported and len(reported) >= 2 and cell.metrics(True)
    assert len(json.dumps(b).encode()) <= 64 * 1024


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_correct_at_a_small_size(workload, trace):
    res = _measure(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    got = set(res["metrics"])
    if trace:
        assert got and got <= {m["name"] for m in BENCHMARK["per_layer"]}
        assert res["breakdown"]["idle_gaps"] is not None
    else:
        assert "setup_s" in got and len(got) >= 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_precision_control_comes_out_not_correct(workload):
    res = _measure(workload, "control")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS
                                            for f in FAULTS[LOADED[w].traffic["kind"]]])
def test_each_fault_the_cell_can_have_comes_out_not_correct(workload, fault):
    res = _measure(workload, fault)
    assert not res["correct"], res["checks"]


def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "dtc-rbf-16k.train", "--seed", "5", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
