"""The program's spans and counters as the benchmark reads them
(harness/program_spans.py, systems/gp_counts.py and the readers that use
them): on synthetic chrome-trace events, a span counted per another, the
idle-after-read rule counting only gaps that open where a read's copy ends,
and every reader that was there before the program had spans reading the
same with them; on the CPU at small sizes, the readings against the
program's arithmetic and None from a program without spans or counters."""

import math

import pytest

import run
from conftest import ROOT, SMALL
from harness import open_loop, program_spans, spec, trace

# the per-layer metrics that read the program's own spans and counters
NEW = {"eval.host_reads.sparse", "device.idle_after_read.sparse", "scg.self_ms.sparse",
       "serve.pad_share.serve"}


def _k(name, ts, dur, stream=7, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}


def _span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _read_trace():
    """A traced part of 100 µs inside one objective: a read whose copy
    [22, 25) opens a gap to 40; a kernel opens one [50, 60); a copy
    outside any read opens [72, 80); a read's copy [85, 87) that a kernel
    on another stream outlasts to 90 opens [90, 100)."""
    return trace.from_events([
        _span("window", 0, 100), _span("objective", 0, 100),
        _span("gpc.host_read", 20, 10), _span("gpc.host_read", 84, 4),
        _k("k0", 0, 22), _k("Memcpy DtoH (Device -> Pageable)", 22, 3, cat="gpu_memcpy"),
        _k("k1", 40, 10), _k("k2", 60, 10), _k("Memcpy DtoH (Device -> Pageable)", 70, 2,
                                                cat="gpu_memcpy"),
        _k("k3", 80, 5), _k("Memcpy DtoH (Device -> Pageable)", 85, 2, cat="gpu_memcpy"),
        _k("other", 84, 6, stream=8)])


def test_idle_after_read_counts_only_gaps_that_follow_a_reads_copy():
    t = _read_trace()
    assert program_spans.read_copies(t) == [(22, 25), (85, 87)]
    # idle: 15 + 10 + 8 + 10 = 43 µs, of which [25, 40) follows a read's copy
    assert program_spans.idle_after_read(t) == pytest.approx(100 * 15 / 43)
    # outside the objective the idle is not counted
    t2 = trace.from_events([
        _span("window", 0, 100), _span("objective", 30, 70), _span("gpc.host_read", 20, 10),
        _k("k0", 0, 22), _k("Memcpy DtoH (Device -> Pageable)", 22, 3, cat="gpu_memcpy"),
        _k("k1", 40, 60)])
    assert program_spans.idle_after_read(t2) == pytest.approx(100.0)


def test_idle_after_read_is_none_without_program_reads():
    t = trace.from_events([_span("window", 0, 100), _span("objective", 0, 100),
                           _k("k0", 0, 22), _k("Memcpy DtoH (Device -> Pageable)", 22, 3,
                                                cat="gpu_memcpy")])
    assert program_spans.idle_after_read(t) is None


def test_reads_per_evaluation_count_the_spans_that_open_in_the_traced_part():
    t = trace.from_events([
        _span("gpc.eval.forward", -50, 20), _span("gpc.host_read", -40, 1),   # before it
        _span("window", 0, 1000),
        _span("gpc.eval.forward", 10, 100), _span("gpc.host_read", 20, 5),
        _span("gpc.host_read", 30, 5, tid=2), _span("gpc.host_read", 200, 5),
        _span("gpc.eval.forward", 500, 100), _span("gpc.host_read", 550, 5),
        _span("gpc.host_read", 1100, 5)])                                    # after it
    assert program_spans.per_span(t, "gpc.host_read", "gpc.eval.forward") == 2.0
    assert program_spans.per_span(t, "gpc.host_read", "gpc.scg.iter") is None
    assert program_spans.per_span(None, "gpc.host_read", "gpc.eval.forward") is None


def test_self_time_is_the_iteration_less_its_evaluations():
    t = trace.from_events([
        _span("window", 0, 1000), _span("gpc.scg.iter", 0, 400), _span("gpc.scg.iter", 500, 300),
        _span("gpc.scg.probe", 10, 150), _span("objective", 15, 140),
        _span("gpc.eval.forward", 20, 50), _span("gpc.eval.backward", 70, 60),
        _span("gpc.eval.fetch", 130, 10), _span("gpc.host_read", 131, 4),
        _span("gpc.eval.forward", 510, 100), _span("gpc.eval.forward", 900, 50)])
    # (400 − 120) and (300 − 100) µs
    assert program_spans.self_ms(t, "gpc.scg.iter", "gpc.eval.") == pytest.approx(0.24)
    assert program_spans.self_ms(t, "gpc.scg.none", "gpc.eval.") is None


def _runs(workload):
    """The same run twice, the second's trace with the program's spans
    added (and a read's copy, which the program's reads issue)."""
    cell = spec.load_cell(ROOT, workload)
    plain = [_span("window", 0, 10000), _span("objective", 100, 3000),
             _span("objective", 4000, 3000), _span("predict", 100, 3000),
             _span("predict", 4000, 3000), _span("scg.host", 50, 9000),
             _k("k1", 200, 1000), _k("k2", 1500, 500, stream=8),
             _k("panel_corr_kernel", 4100, 900), _k("gemm", 5200, 300),
             _k("Memcpy DtoH (Device -> Pageable)", 6000, 5, cat="gpu_memcpy")]
    program = [_span("gpc.scg.iter", 90, 7000), _span("gpc.eval.forward", 110, 900),
               _span("gpc.linalg.chol", 120, 500, tid=1), _span("gpc.host_read", 5990, 30),
               _span("gpc.linalg.chol_bwd", 1200, 800, tid=2), _span("gpc.serve.apply", 4010, 900),
               _span("gpc.serve.fetch", 5950, 100)]
    out = []
    for events in (plain, plain + program):
        r = spec.Run(cell=cell, setup_s=3.0, window_s=10.0, peak_bytes=2 ** 30,
                     evals=[(0.1, 0.2), (0.3, 0.45)], segments=[(0.0, 1.0, 2, 3)],
                     requests=[(0.0, 0.1, 0.2, 100), (0.5, 0.5, 0.8, 4096)],
                     trace=trace.from_events(events))
        out.append(r)
    return cell, out


@pytest.mark.parametrize("workload", ["ftc-rbf-16k-dense.train", "dtc-rbf-16k.train",
                                      "ftc-rbf-16k.serve"])
def test_the_readers_that_were_there_read_the_same_with_program_spans(workload):
    cell, (plain, spanned) = _runs(workload)
    before = [m["name"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]
              if m["name"] not in NEW] + ["k3_roofline"]
    assert len(before) > 10
    for name in before:
        a, b = (cell.reader(name).read(r) for r in (plain, spanned))
        assert (a is None and b is None) or a == b, name
    assert plain.trace.device_ops() == spanned.trace.device_ops()
    assert plain.trace.busy_s == spanned.trace.busy_s


def test_the_span_readers_are_silent_without_program_spans():
    cell, (plain, spanned) = _runs("dtc-rbf-16k.train")
    for name in ("scg.self_ms.sparse", "device.idle_after_read.sparse",
                 "eval.host_reads.sparse"):
        assert cell.reader(name).read(plain) is None
        assert cell.reader(name).read(spanned) is not None


def test_the_counter_reader_is_silent_without_program_counters(monkeypatch):
    from gpc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counts")
    cell, (plain, _) = _runs("ftc-rbf-16k.serve")
    assert cell.reader("serve.pad_share.serve").read(plain) is None


def test_a_dtc_evaluation_reads_the_host_eight_times():
    res = run.measure(spec.load_cell(ROOT, "dtc-rbf-16k.train", SMALL), 2 ** 31 + 3, 0.4,
                      True, "cpu")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["eval.host_reads.sparse"]["value"] == 8.0
    assert got["scg.self_ms.sparse"]["value"] > 0
    assert "device.idle_after_read.sparse" not in got     # no device operations on the CPU


def test_the_padded_share_is_the_buckets_arithmetic_over_the_run():
    from gpc_tpu_torch.utils import profiling

    cell = spec.load_cell(ROOT, "ftc-rbf-16k.serve", SMALL)
    seed, seconds = 2 ** 31 + 5, 0.4
    # the counters of this run alone: the reader reads them from the
    # process's start, and run.py runs each cell in a process of its own
    saved = profiling.counts()
    profiling.COUNTS.clear()
    try:
        res = run.measure(cell, seed, seconds, True, "cpu")
    finally:
        profiling.COUNTS.clear()
        profiling.COUNTS.update(saved)
    assert res["correct"], res["checks"]
    chunk = cell.config["chunk"]
    _, rows, _ = open_loop.schedule(seed, cell.traffic, seconds)
    asked = int(rows.sum()) + sum(open_loop.buckets(chunk))     # the window and set-up's warm-up
    pad = 0
    for r in rows:
        tail = int(r) % chunk
        pad += (min(1 << math.ceil(math.log2(tail)), chunk) - tail) if tail else 0
    assert res["metrics"]["serve.pad_share.serve"]["value"] == pytest.approx(
        100.0 * pad / (asked + pad), rel=1e-12)
