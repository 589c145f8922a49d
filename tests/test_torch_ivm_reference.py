"""The IVM cell `ivm-4096-d512.learn` of the benchmark on the CPU: its plain reference (benchmark/reference/ivm.py)
against the port (gpc_tpu_torch/models/ivm.py) in float64 at N = 64,
d = 16, q = 2, and its harness at a small size.

Tolerances and checks:
  * greedy selection: the same order; μ, ς and the site means and
    precisions within 1e-10 of each field's largest reference entry, at the
    CLI's Gaussian σ² of 1e-6 and at 0.01, for one output and for two;
  * the reference's replay along the port's order: no score gap, the same
    state; a point added twice, or one outside the data, reads inf;
  * the active-set and the noise objectives and their gradients within
    1e-10, relative, at θ₀ and at points around it;
  * the `ivm_rounds` traffic kind with overrides of the configuration and the
    traffic (N = 128, d = 16, rounds of 6 and 3 SCG iterations): correct
    under the committed limits, with and without tracing; the precision
    control and the stale, half and frozen faults not correct; the swap
    fault read as the reference's own margin between the largest and the
    second score at the swapped step;
  * in float32 at the cell's size, the active points' ς + σ² positive;
  * harness/ivm_work.py's counts against a count by hand at d = 4, N = 8;
  * the metric readers on a synthetic trace, and the import guard clean on
    the reference."""

import functools
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch.models.ivm import IVM, replay
from gpc_tpu_torch.noise import GaussianNoise

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import data, flops, guard, ivm_work, spec, trace  # noqa: E402

CELL = "ivm-4096-d512.learn"
# The cell's entry in BENCHMARK.json and its per-layer metrics, each moving
# train_iter_ms.sparse; the files it names are in benchmark/.
WORKLOAD = {"name": CELL, "config": "ivm-rbf-4096-d512", "traffic": "ivm-learn-e2", "chips": 1}
PER_LAYER = [("ivm.select_ms.ivm", "ms", "program_span"), ("ivm.select_idle.ivm", "%", "device_trace"),
             ("ivm.kernels_per_step.ivm", "kernels/step", "device_trace"),
             ("ivm.select_roofline.ivm", "%", "device_trace"),
             ("ivm.kern_round_ms.ivm", "ms", "program_span"), ("mfu.ivm", "%", "host_clock")]
REF = spec.module(ROOT, "reference", "ivm")
N, D_ACTIVE, Q = 64, 16, 2
FIELDS = ("mu", "varsigma", "m_site", "beta_site")
SMALL = {"config": {"N": 128, "d": 16}, "traffic": {"kern_iters": 6, "noise_iters": 3,
                                                     "sample": 2}}
SEED = 2 ** 31 + 11


@functools.lru_cache(maxsize=None)
def _bench_run():
    """benchmark/run.py, loaded once under a name of its own."""
    spec_ = importlib.util.spec_from_file_location("_bench_run_py", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _cfg(outputs=1, n=N):
    return {"N": n, "d": D_ACTIVE, "q": Q, "D": outputs,
            "precision": {"factor": "f32", "products": "f32"}}


def _model(seed, outputs=1, sigma2=None):
    X, y = data.regression(seed, N, Q, outputs, 0.1)
    kern = KM.Cmpnd(input_dim=Q, components=(KM.Rbf(input_dim=Q), KM.Bias(input_dim=Q),
                                             KM.White(input_dim=Q)))
    m = IVM(kern, GaussianNoise(output_dim=outputs), X, y, num_active=D_ACTIVE, device="cpu")
    if sigma2 is not None:
        m.noise_params[-1] = sigma2
    return m


def _gap(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    assert a.shape == b.shape
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed,outputs,sigma2", [(0, 1, None), (1, 1, None), (2, 1, 0.01),
                                                 (3, 2, None), (4, 2, 0.01)])
def test_reference_selection_matches_the_port(seed, outputs, sigma2):
    m = _model(seed, outputs, sigma2)
    st = m.init_and_select()
    ref_st, order = REF.select(_cfg(outputs), m.X, m.y, m.kern_params, m.noise_params)
    np.testing.assert_array_equal(order, st.active_idx.numpy())
    for f in FIELDS:
        assert _gap(getattr(st, f), ref_st[f]) <= 1e-10, f


def test_the_replay_along_the_port_order_has_no_gap():
    m = _model(5)
    st = m.init_and_select()
    order = st.active_idx.numpy()
    ref_st, gaps = REF.replay(_cfg(), m.X, m.y, m.kern_params, m.noise_params, order)
    assert gaps.shape == (D_ACTIVE,) and gaps.max() <= 1e-12
    for f in FIELDS:
        assert _gap(getattr(st, f), ref_st[f]) <= 1e-10, f
    # the port's own float64 replay reads the same
    _, port_gaps = replay(m.spec, m.kern_params, m.noise_params, m.Xd, m.yd, order)
    assert port_gaps.max() <= 1e-12


@pytest.mark.parametrize("bad", ["repeated", "outside"])
def test_the_replay_reads_a_point_that_is_not_inactive_as_inf(bad):
    m = _model(6)
    order = m.init_and_select().active_idx.numpy().copy()
    order[5] = order[2] if bad == "repeated" else N + 3
    _, gaps = REF.replay(_cfg(), m.X, m.y, m.kern_params, m.noise_params, order)
    assert len(gaps) == 6 and math.isinf(gaps[-1]) and gaps[:5].max() <= 1e-12


@pytest.mark.parametrize("shift", [0.0, 0.3, -0.7])
def test_the_active_objective_and_gradient_match_the_port(shift):
    m = _model(7)
    st = m.init_and_select()
    ref_st, order = REF.select(_cfg(), m.X, m.y, m.kern_params, m.noise_params)
    a = REF.kern_a(m.kern_params) + shift * np.array([1.0, -0.5, 0.25, 1.0])
    f, g = m._kern_vag(m._t(m.active_X()), st.m_site, st.beta_site)(a)
    f_ref, g_ref = REF.active_nll_and_grad(_cfg(), m.X[order], ref_st["m_site"],
                                           ref_st["beta_site"], a)
    assert abs(f - f_ref) <= 1e-10 * abs(f_ref)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-10 * np.abs(g_ref).max())


@pytest.mark.parametrize("outputs,shift", [(1, 0.0), (1, 2.5), (2, 0.0), (2, 4.0)])
def test_the_noise_objective_and_gradient_match_the_port(outputs, shift):
    m = _model(8, outputs)
    st = m.init_and_select()
    ref_st, _ = REF.select(_cfg(outputs), m.X, m.y, m.kern_params, m.noise_params)
    a = REF.noise_a(m.noise_params)
    a[-1] += shift
    a[:-1] += 0.05 * shift
    f, g = m._noise_vag(st.mu, st.varsigma)(a)
    f_ref, g_ref = REF.noise_nll_and_grad(_cfg(outputs), m.y, ref_st["mu"],
                                          ref_st["varsigma"], a)
    assert abs(f - f_ref) <= 1e-10 * abs(f_ref)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-10 * np.abs(g_ref).max())


def _cell(overrides=None) -> spec.Cell:
    """The cell found by its names in BENCHMARK.json, with `overrides` of its
    configuration and traffic."""
    return spec.load_cell(ROOT, CELL, overrides)


def test_benchmark_json_holds_the_cell_its_config_and_its_metrics():
    bench = spec.read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    assert {k: cells[CELL][k] for k in WORKLOAD} == WORKLOAD
    config = {c["name"]: c for c in bench["configs"]}[WORKLOAD["config"]]
    assert config["reduced"] == [] and config["source"].endswith("CIvm.cpp")
    assert spec.read_json(ROOT / config["file"])["name"] == WORKLOAD["config"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["train_iter_ms.sparse"]["workloads"]
    assert [m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])] == [
        "setup_s", "train_iter_ms.sparse", "peak_gib"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, unit, source in PER_LAYER:
        m = per_layer[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            unit, source, "train_iter_ms.sparse", [CELL])
    assert [m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])] == [
        n for n, _, _ in PER_LAYER]


def _measure(variant=None, trace_on=False):
    ov = json.loads(json.dumps(SMALL))
    if variant == "control":
        ov["config"]["system"] = "ivm_control"
    elif variant:
        ov["config"].update(system="ivm_faults", fault=variant)
    return _bench_run().measure(_cell(ov), SEED, 0.3, trace_on, "cpu")


@pytest.mark.parametrize("trace_on", [False, True], ids=["trace0", "trace1"])
def test_the_cell_runs_correct_at_a_small_size(trace_on):
    res = _measure(trace_on=trace_on)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    got = set(res["metrics"])
    if trace_on:
        # the CPU has no device operations: the span and host-clock readers read
        assert {"ivm.select_ms.ivm", "ivm.kern_round_ms.ivm", "mfu.ivm"} <= got
    else:
        assert {"setup_s", "train_iter_ms.sparse"} <= got
    assert set(res["checks"]) == set(spec.read_json(BENCH / "limits" / f"{CELL}.json"))


@pytest.mark.parametrize("variant", ["control", "stale", "half", "frozen"])
def test_the_control_and_each_fault_come_out_not_correct(variant):
    res = _measure(variant)
    assert not res["correct"], res["checks"]


def test_the_swapped_pick_reads_the_reference_margin_at_its_step():
    res = _measure("swap")
    X, y = data.regression(SEED, 128, Q, 1, 0.1)
    cell = _cell(SMALL)
    m = cell.system().model(cell.config, X, y, 1, "cpu")
    seg = cell.system()
    seg.restore(m, seg.start(m), None)
    seg.optimise(m, cell.traffic)
    # the last pass's parameters are the segment's result: the swap's step
    # is d/2 of a pass at them; the margin there is what the check reads
    cfg = dict(cell.config)
    adf = REF._Adf(cfg, X, y, m.kern_params, m.noise_params, "cpu", "f64")
    for _ in range(cfg["d"] // 2):
        adf.add(int(torch.argmax(adf.scores())))
    top2 = torch.topk(adf.scores(), 2).values
    margin = float((top2[0] - top2[1]) / top2[0].abs())
    assert margin > 0
    assert res["checks"]["pick_gap"]["value"] == pytest.approx(margin, rel=1e-6)


def test_the_work_counts_match_a_count_by_hand():
    n, d, q, D = 8, 4, 2, 1
    by_hand_bytes = by_hand_flops = 0
    for k in range(d):
        by_hand_bytes += 4 * (k * n + n * q + 8 * n * D + n * D + n + (k + 1))
        by_hand_flops += 2 * k * n + n * (2 * q + 6) + 15 * n * D
    assert ivm_work.pass_bytes(n, d, q, D) == by_hand_bytes == 4 * (48 + 4 * 96 + 10)
    assert ivm_work.pass_flops(n, d, q, D) == by_hand_flops == 96 + 4 * (80 + 120)
    cfg = {"N": n, "d": d, "q": q, "D": D}
    assert ivm_work.kern_eval_flops(cfg) == flops.ftc_evaluation(d, q, D)
    assert ivm_work.noise_eval_flops(cfg) == 16 * n
    assert ivm_work.segment_flops(cfg, 5, 3, 2) == (5 * by_hand_flops + 3 * flops.ftc_evaluation(
        d, q, D) + 2 * 16 * n)
    # at the cell's size the byte floor binds: 2d²N bytes of M, ≈ 0.67 ms a pass
    cell = {"N": 4096, "d": 512, "q": 2, "D": 1}
    assert ivm_work.pass_least_s(cell) == pytest.approx(
        ivm_work.pass_bytes(4096, 512, 2, 1) / 3.35e12)
    assert 0.6e-3 < ivm_work.pass_least_s(cell) < 0.7e-3


def _reader(name):
    return spec.module(ROOT, "metrics", name).read


class _Run:
    def __init__(self, events, counts=None):
        self.trace = trace.from_events(events)
        self.counts = counts
        self.config = {"N": 4096, "d": 512, "q": 2, "D": 1}


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _kernel(ts, dur):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {"stream": 7}}


def test_the_selection_readers_on_a_synthetic_trace():
    # two passes of 100 µs, each with 3 kernels of 20 µs; one kernel outside
    events = [_span("window", 0, 1000), _span("gpc.ivm.select", 100, 100),
              _span("gpc.ivm.select", 500, 100), _span("gpc.ivm.kern_round", 700, 250)]
    events += [_kernel(t, 20) for t in (110, 140, 170, 510, 540, 570, 800)]
    run = _Run(events, ({"ivm.steps": 10}, {"ivm.steps": 13}))
    assert _reader("ivm.select_ms.ivm")(run) == pytest.approx(0.1)
    assert _reader("ivm.kern_round_ms.ivm")(run) == pytest.approx(0.25)
    assert _reader("ivm.select_idle.ivm")(run) == pytest.approx(40.0)
    assert _reader("ivm.kernels_per_step.ivm")(run) == pytest.approx(6 / 3)
    least = ivm_work.pass_least_s(run.config)
    assert _reader("ivm.select_roofline.ivm")(run) == pytest.approx(100 * 2 * least / 120e-6)
    # a program that opens no such span, or counts no step, reads nothing
    bare = _Run([_span("window", 0, 1000), _kernel(10, 5)], ({}, {}))
    for name in ("ivm.select_ms.ivm", "ivm.select_idle.ivm", "ivm.kernels_per_step.ivm",
                 "ivm.select_roofline.ivm", "ivm.kern_round_ms.ivm"):
        assert _reader(name)(bare) is None
    assert _reader("ivm.kernels_per_step.ivm")(_Run(events, None)) is None


@pytest.mark.parametrize("trace_on", [False, True], ids=["trace0", "trace1"])
def test_the_ivm_readers_read_nothing_in_a_gp_cell(trace_on):
    """Every reader this cell adds gives None, and does not raise, on the run
    record of a GP training cell (its segments have fewer fields, its
    configuration no active set, its trace no IVM span)."""
    import time

    gp = spec.load_cell(ROOT, "dtc-rbf-16k.train",
                        {"config": {"N": 256, "M": 16}, "traffic": {"iterations": 6, "sample": 8}})
    record = spec.Run(cell=gp)
    gp.driver().run(gp, SEED, 0.3, trace_on, "cpu", time.perf_counter(), record)
    assert record.segments
    ivm = _cell()
    for name, _, _ in PER_LAYER:
        assert ivm.reader(name).read(record) is None, name


def test_the_import_guard_is_clean_on_the_reference():
    names = guard.imported_names(BENCH / "reference" / "ivm.py")
    assert not names & (guard.FORBIDDEN | {guard.PROGRAM})
    assert guard.reference_violations(BENCH / "reference") == []


def test_in_float32_the_active_points_keep_a_positive_variance(monkeypatch):
    """The card's working dtype on the CPU, at the cell's size: the picked
    point's own ς in the form ς/(1 + ς·β̃) keeps ς + σ² > 0 at the CLI's
    σ² of 1e-6 (the subtraction ς − s²·ν left 13–19 active points below 0
    at seeds 101–103), so the noise model's objective is finite and near
    the float64 reference's."""
    import gpc_tpu_torch

    monkeypatch.setattr(gpc_tpu_torch, "work_dtype", lambda device: torch.float32)
    cfg = {"N": 4096, "d": 512, "q": Q, "D": 1, "precision": {"factor": "f32", "products": "f32"}}
    X, y = data.regression(101, cfg["N"], Q, 1, 0.1)
    kern = KM.Cmpnd(input_dim=Q, components=(KM.Rbf(input_dim=Q), KM.Bias(input_dim=Q),
                                             KM.White(input_dim=Q)))
    m = IVM(kern, GaussianNoise(output_dim=1), X, y, num_active=cfg["d"], device="cpu")
    st = m.init_and_select()
    assert st.varsigma.dtype == torch.float32
    assert bool((st.varsigma + m.noise_params[-1] > 0).all())
    a = REF.noise_a(m.noise_params)
    f, _ = m._noise_vag(st.mu, st.varsigma)(a)
    ref_st, _ = REF.replay(cfg, X, y, m.kern_params, m.noise_params, st.active_idx.numpy())
    f_ref, _ = REF.noise_nll_and_grad(cfg, y, ref_st["mu"], ref_st["varsigma"], a)
    assert np.isfinite(f) and abs(f - f_ref) / cfg["N"] < 1e-5
    for field in FIELDS:
        assert _gap(getattr(st, field), ref_st[field]) < 1e-3, field
