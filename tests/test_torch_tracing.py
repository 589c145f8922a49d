"""The port's spans and counters (gpc_tpu_torch/utils/profiling.py) on the
CPU: off without a profiler, named and nested as the layers call each other
under one, a `gpc.host_read` span for every counted host read, GPServer's
padding counted by hand, the dense evidence's own backward counted, and no
program span named as a benchmark span."""

import collections
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch import linalg
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.optim import run_optimiser
from gpc_tpu_torch.serving import GPServer
from gpc_tpu_torch.utils import profiling

PKG = Path(profiling.__file__).resolve().parents[1]
# the spans the benchmark's harness opens around its calls into the program
# (benchmark/harness/spans.py, scg_segments.py, open_loop.py), which its
# readers find by exact name
HARNESS_SPANS = {"window", "objective", "scg.host", "serve.wait", "predict"}


def _kern(q=2):
    return KM.Cmpnd(input_dim=q, components=(KM.Rbf(input_dim=q), KM.Bias(input_dim=q),
                                             KM.White(input_dim=q)))


def _data(n=64, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, q))
    return X, np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))


def _dtc():
    X, y = _data()
    return GP(_kern(), X, y, approx="dtc", num_active=8, beta=1.0, seed=1, device="cpu")


def _ftc():
    X, y = _data()
    return GP(_kern(), X, y, device="cpu")


def _spans(fn, tmp_path):
    """Run fn under a CPU profiler: (its result, [(name, start, end)] of the
    program's spans, sorted by start, the counters' change)."""
    before = profiling.counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    after = profiling.counts()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("gpc.")),
                   key=lambda s: (s[1], -s[2]))
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return out, spans, delta


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(spans, s):
    """The innermost span holding s (None at the top)."""
    holders = [o for o in spans if o is not s and _inside(s, o)]
    return max(holders, key=lambda o: o[1])[0] if holders else None


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def recorded(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    monkeypatch.setattr(profiling, "COUNTS", collections.Counter())
    assert profiling.span("gpc.a") is profiling.span("gpc.b")
    assert profiling.host_read("site") is profiling.span("gpc.c")
    assert profiling.COUNTS == {"host_read.site": 1}
    vag = _dtc().value_and_grad_fn()
    vag(_dtc().theta)
    GPServer(_ftc(), chunk=16).predict(np.zeros((20, 2)))


def test_an_evaluation_under_scg_nests_its_spans_as_the_layers_call(tmp_path):
    gp = _dtc()
    _, spans, delta = _spans(lambda: run_optimiser("scg", gp.value_and_grad_fn(),
                                                   gp.theta.copy(), 2), tmp_path)
    parent = {}
    for s in spans:
        parent.setdefault(s[0], set()).add(_parent(spans, s))
    count = {name: sum(n == name for n, _, _ in spans) for name in parent}
    assert parent["gpc.scg.iter"] == {None} and count["gpc.scg.iter"] == 2
    assert parent["gpc.scg.probe"] == parent["gpc.scg.trial"] == {"gpc.scg.iter"}
    # the initial evaluation runs before the first iteration
    assert parent["gpc.eval.forward"] == {None, "gpc.scg.probe", "gpc.scg.trial"}
    assert parent["gpc.eval.backward"] == parent["gpc.eval.forward"]
    assert parent["gpc.eval.fetch"] == parent["gpc.eval.forward"]
    assert parent["gpc.linalg.chol"] == {"gpc.eval.forward"}
    assert parent["gpc.linalg.chol_bwd"] == {"gpc.eval.backward"}
    assert parent["gpc.host_read"] == {"gpc.linalg.chol", "gpc.eval.forward",
                                       "gpc.linalg.chol_bwd", "gpc.eval.fetch"}
    n_evals = count["gpc.eval.forward"]
    assert n_evals == count["gpc.eval.backward"] == count["gpc.eval.fetch"]
    assert n_evals == 1 + count["gpc.scg.probe"] + count["gpc.scg.trial"]
    assert count["gpc.scg.trial"] == 2
    # K_uu and Am: three reads a factor (its info, L[-1, -1], its backward), two fetches
    assert delta["host_read.chol_info"] == delta["host_read.jitchol_finite"] == 2 * n_evals
    assert delta["host_read.chol_bwd_finite"] == 2 * n_evals
    assert delta["host_read.fetch"] == 2 * n_evals


@pytest.mark.parametrize("case", ["scg", "jitter"])
def test_every_counted_host_read_is_one_host_read_span(case, tmp_path):
    if case == "scg":
        gp = _dtc()
        fn = lambda: run_optimiser("scg", gp.value_and_grad_fn(), gp.theta.copy(), 3)   # noqa: E731
    else:
        B = torch.as_tensor(np.random.default_rng(3).standard_normal((12, 4)))
        A = (B @ B.T).requires_grad_(True)             # rank 4: found only with jitter

        def fn():
            L, jitter = linalg.jitchol(A)
            linalg.chol_logdet(L).backward()
            return jitter
    out, spans, delta = _spans(fn, tmp_path)
    reads = sum(v for k, v in delta.items() if k.startswith("host_read."))
    assert reads == sum(n == "gpc.host_read" for n, _, _ in spans) > 0
    if case == "jitter":
        assert out > 0 and delta["host_read.jitter"] >= 2
        loop = [s for s in spans if s[0] == "gpc.linalg.jitter"]
        assert len(loop) == 1
        assert sum(_inside(s, loop[0]) for s in spans if s[0] == "gpc.host_read") == \
            delta["host_read.jitter"]


@pytest.mark.parametrize("approx", ["ftc", "dtc"])
def test_the_dense_evidence_backward_forms_one_inverse_and_no_cholesky_vjp(approx, tmp_path):
    """An FTC value_and_grad under `dense` runs one `gpc.linalg.evidence_bwd`
    (inside `gpc.eval.backward`, with the one finiteness read) in place of
    `gpc.linalg.chol_bwd`, and counts one `evidence.inverse_vjp`; DTC's
    factors keep the Cholesky VJP and leave the counter alone."""
    gp = _ftc() if approx == "ftc" else _dtc()
    vag = gp.value_and_grad_fn()
    _, spans, delta = _spans(lambda: vag(gp.theta), tmp_path)
    count = collections.Counter(n for n, _, _ in spans)
    if approx == "dtc":
        assert "evidence.inverse_vjp" not in delta and count["gpc.linalg.evidence_bwd"] == 0
        assert count["gpc.linalg.chol_bwd"] == 2
        return
    assert delta["evidence.inverse_vjp"] == 1 and delta["host_read.chol_bwd_finite"] == 1
    assert count["gpc.linalg.evidence_bwd"] == 1 and count["gpc.linalg.chol_bwd"] == 0
    (bwd,) = (s for s in spans if s[0] == "gpc.linalg.evidence_bwd")
    assert _parent(spans, bwd) == "gpc.eval.backward"


def test_profile_slice_prints_the_inverse_count_beside_the_host_reads(monkeypatch, capsys):
    from gpc_tpu_torch import profile_slice

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    gp = _ftc()
    vag = gp.value_and_grad_fn()
    report = []
    profile_slice.stage("value_and_grad dense", lambda: vag(gp.theta), report)
    head = capsys.readouterr().out.splitlines()[0]
    reads, counters = head.split("host reads ")[1].split(", counters ")
    assert "'chol_bwd_finite': 1" in reads and counters == "{'evidence.inverse_vjp': 1}"
    assert report[0].startswith("== " + head)


def test_a_served_batch_spans_its_staging_posterior_and_copies(tmp_path):
    server = GPServer(_ftc(), chunk=16)
    (mu, var), spans, delta = _spans(lambda: server.predict(np.zeros((20, 2))), tmp_path)
    assert mu.shape == var.shape == (20, 1)
    names = [n for n, _, _ in spans if n.startswith("gpc.serve.")]
    assert names == ["gpc.serve.stage", "gpc.serve.apply", "gpc.serve.fetch"] * 2
    serve = [s for s in spans if s[0].startswith("gpc.serve.")]
    assert all(a[2] <= b[1] for a, b in zip(serve, serve[1:]))       # one after another
    assert delta == {"serve.rows": 20}              # 16, then 4: each a bucket


def test_served_rows_and_padded_rows_count_chunks_and_ragged_tails():
    server = GPServer(_ftc(), chunk=64)
    before = profiling.counts()
    for rows in (1, 37, 64, 100):
        mu, _ = server.predict(np.zeros((rows, 2)))
        assert mu.shape == (rows, 1)
    after = profiling.counts()
    delta = {k: after[k] - before.get(k, 0) for k in ("serve.rows", "serve.pad_rows")}
    # 1 → 1; 37 → 64 (27 added); 64 → 64; 100 → 64 + 36 → 64 + 64 (28 added)
    assert delta == {"serve.rows": 202, "serve.pad_rows": 27 + 28}


def test_counts_is_a_snapshot_of_the_counters(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTS", collections.Counter({"serve.rows": 3}))
    got = profiling.counts()
    with profiling.host_read("site"):
        pass
    assert got == {"serve.rows": 3}
    assert profiling.counts() == {"serve.rows": 3, "host_read.site": 1}


def test_no_program_span_is_named_as_a_harness_span(tmp_path):
    named = set()
    for path in PKG.rglob("*.py"):
        named |= set(re.findall(r"\bspan\(\"([^\"]+)\"\)", path.read_text()))
    assert {"gpc.scg.iter", "gpc.eval.fetch", "gpc.linalg.chol_bwd", "gpc.serve.apply",
            "gpc.host_read"} <= named
    assert all(n.startswith("gpc.") for n in named), named
    gp = _dtc()
    _, spans, _ = _spans(lambda: (run_optimiser("scg", gp.value_and_grad_fn(), gp.theta.copy(), 1),
                                  GPServer(gp, chunk=16).predict(np.zeros((5, 2)))), tmp_path)
    recorded = {n for n, _, _ in spans}
    assert recorded <= named and not (named | recorded) & HARNESS_SPANS


class _Prof:
    """A profiler that exports a given chrome trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        Path(path).write_text(json.dumps({"traceEvents": self.events}))


def test_profile_slice_counts_overlapping_streams_once():
    from gpc_tpu_torch import profile_slice

    def k(name, ts, dur, stream):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}

    # a leaf chain beside the fills below it on a second stream (K3's two
    # streams), and a kernel launched early on the first stream
    prof = _Prof([k("chain", 0, 60, 1), k("below", 10, 60, 2), k("early", 50, 30, 1),
                  k("copy", 90, 5, 1), {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 9}])
    clipped = profile_slice.trace_kernels(prof)
    assert [(n, s, a, b) for n, s, a, b in clipped] == [
        ("chain", 1, 0, 60), ("below", 2, 10, 70), ("early", 1, 60, 80), ("copy", 1, 90, 95)]
    assert sum(b - a for _, _, a, b in clipped) == 145       # the streams' sum passes the 95 µs
    assert profile_slice.busy_us(clipped) == 85              # [0, 80) and [90, 95)
