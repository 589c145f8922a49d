"""The port's weak-scaling harness and collective census
(gpc_tpu_torch/parallel/scaling_bench.py, parallel/mesh.COLLECTIVES) on
gloo at world sizes 1 and 2 (tests/helpers/torch_dist2_worker.py, case
"scaling"), in float64.

gpc_tpu counts the collectives of the compiled HLO; the port counts the
calls it makes, so the census is exact: a dist_ftc value_and_grad at
N = 16·world gathers X, the mask and m once each and every (N, N/world)
factor panel three times (one forward sweep, two in the backward), which is
3× gpc_tpu's analytic forward volume N² (its analytic_bytes_per_forward),
and all-reduces θ̄ once.  The record has gpc_tpu's keys (with
collectives_measured for its collectives_static), run() returns one line
for the world, and `python -m gpc_tpu_torch.parallel.scaling_bench`
prints gpc_tpu's JSON line for each world it starts; without a card it
refuses unless asked for the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch.parallel import scaling_bench as SB

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
from torch_dist2_worker import spawn_worlds  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2)
ROWS, Q, D = 16, 4, 1
GPC_TPU_KEYS = {"n_devices", "n", "rows_per_device", "program", "panel_trip_count",
                "analytic_allgather_elems_per_forward", "analytic_bytes_per_forward",
                "analytic_bytes_per_value_and_grad", "note"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import numpy as np
    return spawn_worlds("scaling", dict(rows=np.array(ROWS), run_rows=np.array(64),
                                        run_m=np.array(8)), WORLDS, tmp_path_factory)


@pytest.mark.parametrize("world", WORLDS)
def test_artifact_and_its_census(runs, world):
    for r in runs[world]:
        art = json.loads(str(r["artifact"]))
        rec = art["weak_scaling_proxy"]
        assert set(rec) - {"collectives_measured"} == GPC_TPU_KEYS
        n = world * ROWS
        assert (rec["n_devices"], rec["n"], rec["panel_trip_count"]) == (world, n, world)
        assert rec["analytic_bytes_per_forward"] == n * n * 8
        census = rec["collectives_measured"]
        assert set(census) == {"all-gather", "all-reduce"}
        assert census["all-gather"]["count"] == 3 + 3 * world
        assert census["all-gather"]["bytes"] == 8 * (n * Q + n + n * D) + 3 * 8 * n * n
        n_theta = 4                              # rbf (2), bias, white
        assert census["all-reduce"] == {"count": 1, "bytes": 8 * n_theta}
        it = art["iterative_weak_scaling_proxy"]["collectives_measured"]
        assert it["all-gather"]["count"] >= 3 and it["all-gather"]["bytes"] > 0
        assert it["all-reduce"]["count"] == 1           # p̄ of the shared p (X is data)


@pytest.mark.parametrize("world", WORLDS)
def test_run_times_the_current_world(runs, world):
    for r in runs[world]:
        line = json.loads(str(r["run"]))
        assert (line["devices"], line["n"]) == (world, 64 * world)
        assert line["t_ms"] > 0
        assert line["census"]["all-reduce"]["count"] > 0


def test_main_prints_one_line_a_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "gpc_tpu_torch.parallel.scaling_bench", "32",
                          "8", "--device", "cpu", "--worlds", "1,2"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert [ln["devices"] for ln in lines] == [1, 2]
    assert [ln["n"] for ln in lines] == [32, 64]
    assert set(lines[0]) == {"devices", "n", "t_ms", "efficiency"}
    assert lines[0]["efficiency"] == 1.0 and lines[1]["efficiency"] > 0


def test_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        SB.main(["32", "8", "--worlds", "1"])
