"""The trace arithmetic and the yardstick on synthetic traces: per-stream
clipping, the union of intervals (two overlapping streams, whose sum would
pass 100 %), idle gaps by host span, and the FLOP counts and bounds."""

import pytest

from harness import flops, peaks, trace


def _k(name, ts, dur, stream, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def test_a_kernel_launched_early_starts_where_the_one_before_it_ended():
    ops = trace.clip_streams([_k("a", 0, 10, 7), _k("b", 2, 12, 7), _k("c", 5, 3, 8)])
    assert [(n, s, a, b) for n, s, a, b in ops] == [("a", 7, 0, 10), ("b", 7, 10, 14),
                                                    ("c", 8, 5, 8)]


def test_two_overlapping_streams_count_once_in_the_busy_time():
    events = [_span("window", 0, 100),
              _k("chain", 0, 60, 1), _k("below", 10, 60, 2), _k("copy", 90, 5, 1, "gpu_memcpy")]
    t = trace.from_events(events)
    summed = sum(b - a for _, _, a, b in t.ops)
    assert summed / t.window_s / 1e6 > 1.0        # a sum of the streams passes 100 %
    assert t.busy_s == pytest.approx(75e-6)       # [0, 70) and [90, 95)
    assert 1.0 - t.busy_s / t.window_s == pytest.approx(0.25)


def test_the_busy_time_is_clipped_to_the_traced_part():
    t = trace.from_events([_span("window", 10, 20), _k("k", 0, 15, 1), _k("l", 25, 20, 1)])
    assert t.busy_s == pytest.approx(10e-6)


def test_idle_gaps_are_labelled_by_the_innermost_host_span():
    events = [_span("window", 0, 100), _span("scg.host", 0, 100), _span("objective", 0, 40),
              _span("objective", 60, 40),
              _k("k1", 0, 30, 1), _k("k2", 60, 30, 1)]
    gaps = trace.from_events(events).idle_gaps("harness")
    labels = {name.split(":")[0]: s for name, s in gaps}
    assert labels["scg.host"] == pytest.approx(30e-6)    # [30, 60): its middle is outside
    assert labels["objective"] == pytest.approx(10e-6)   # [90, 100)
    assert gaps[0][1] >= gaps[-1][1]


def test_device_ops_are_the_kernels_with_most_time_first():
    t = trace.from_events([_span("window", 0, 100), _k("small", 0, 5, 1), _k("big", 10, 50, 1),
                           _k("small", 70, 5, 1)])
    assert t.device_ops() == [["big", 50e-6], ["small", 10e-6]]


def test_a_trace_needs_exactly_one_window():
    with pytest.raises(ValueError):
        trace.from_events([_k("k", 0, 1, 1)])


def test_the_ftc_evaluation_count_is_the_forward_and_its_gradient():
    n, q = 16384, 8
    fwd = 2 * n * n * q + n ** 3 / 3 + 2 * n * n
    assert flops.ftc_forward(n, q, 1) == pytest.approx(fwd)
    assert flops.evaluation({"approx": "ftc", "N": n, "q": q, "D": 1}) == pytest.approx(
        fwd + 2 * n ** 3 / 3 + n * n * (2 * q + 6) + n * n)
    assert flops.evaluation({"approx": "ftc", "N": n, "q": q, "D": 1}) == pytest.approx(4.409e12,
                                                                                         rel=1e-3)


def test_a_request_counts_its_solve_and_not_an_explicit_inverse():
    cfg = {"approx": "ftc", "N": 1000, "q": 8, "D": 1}
    assert flops.request(cfg, 10) - flops.request(cfg, 0) == pytest.approx(
        10 * (1000 * 22 + 2000 + 1000 ** 2 + 2000))
    dtc = {"approx": "dtc", "N": 1000, "q": 8, "D": 1, "M": 64}
    assert flops.request(dtc, 10) < flops.request(cfg, 10)


def test_the_k3_bound_is_chip_smokes_with_the_diagonal_output():
    ops_s = (16384 ** 3 / 3 + 16384 ** 2 * 128) / 989e12 + (
        16384 ** 2 / 2 * 22 + 128 * 2 * 128 ** 3 / 3 + 16384 ** 2) / 67e12
    assert peaks.k3_bound_s(16384, 8, 1) == pytest.approx(ops_s)
    assert peaks.k3_bound_s(16384, 8, 1, diag=False) == pytest.approx(ops_s)
    assert peaks.bound_s(3.35e12, {"f32": 1.0})[1] == "bytes"
