"""sweep.summary on a hand-made run of five requests, and serve_runs: its
two lines from a small run on the CPU, its refusal without a card, and no
result where a forbidden module is loaded once the window has closed."""

import json
import sys
import types

import pytest

import serve_runs
import sweep
from harness import spec
from conftest import ROOT, SMALL


def test_the_summary_of_a_hand_made_run():
    # (due, start, end, rows) in seconds: the second request is due while
    # the first is served, the fourth while the third is
    requests = [(0.000, 0.000, 0.010, 4096), (0.005, 0.010, 0.011, 8),
                (0.020, 0.020, 0.021, 64), (0.0205, 0.021, 0.0215, 2),
                (0.030, 0.030, 0.031, 200)]
    a = sweep.summary(100.0, requests)
    assert a["requests"] == 5 and a["rate"] == 100.0
    assert a["waited_share"] == pytest.approx(2 / 5)
    # latencies 10, 6, 1, 1, 1 ms
    assert a["p50_ms"] == pytest.approx(1.0)
    assert a["p95_ms"] == pytest.approx(6 + 0.8 * 4)
    # the small requests that found the server free: only the third
    assert a["small_free_p50_ms"] == pytest.approx(1.0)
    assert a["service_ms"] == pytest.approx((10 + 1 + 1 + 0.5 + 1) / 5)
    assert a["small_service_ms"] == pytest.approx(1.0)
    assert a["wait_ms"] == pytest.approx((0 + 5 + 0 + 0.5 + 0) / 5)
    assert a["backlog_at_close"] == 1


def _small_serve():
    return spec.load_cell(ROOT, "ftc-rbf-16k.serve", SMALL)


def test_a_small_run_prints_the_result_and_its_summary(capsys):
    assert serve_runs.one(_small_serve(), 2 ** 31 + 5, 0.3, "cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    result, line = json.loads(out[-2]), json.loads(out[-1])
    assert result["correct"] and line["correct"]
    assert line["requests"] == result["attempted"]
    assert line["p50_ms"] == pytest.approx(result["metrics"]["serve_p50_ms"]["value"])
    assert line["p95_ms"] == pytest.approx(result["metrics"]["serve_p95_ms"]["value"])
    assert 0.0 <= line["waited_share"] <= 1.0


def test_with_a_forbidden_module_loaded_it_prints_nothing_and_fails(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "gpc_tpu", types.ModuleType("gpc_tpu"))
    assert serve_runs.one(_small_serve(), 2 ** 31 + 5, 0.3, "cpu") != 0
    got = capsys.readouterr()
    assert got.out == ""
    assert "import guard: loaded module gpc_tpu" in got.err


def test_without_a_card_it_prints_nothing_and_fails(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_runs.main(["--workload", "ftc-rbf-16k.serve", "--seed", "1",
                            "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
