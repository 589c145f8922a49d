"""Where the time of the inference, training, sparse, IVM and GP-LVM slices goes on one NVIDIA GPU.

    python -m gpc_tpu_torch.profile_slice [--n 16384] [--q 8] [--sparse | --ivm | --gplvm | --bench]
        [--out FILE]

Runs each stage once to warm up, then once under torch.profiler: the panel
evidence (K3), the dense evidence (Gram + jitchol + solves), the GPServer
factor (explicit inverse), one served batch of 8192 rows, one
value_and_grad of the training objective per engine (dense: K1 + jitchol,
the K1 VJP and the evidence's K⁻¹ backward; panel: K3 "full+diag" + the explicit-K⁻¹ backward),
and one value_and_grad with cmpnd(mlp, bias, white) under dense (K4 +
jitchol) and under lazy (the left-looking sweep with K4 blocks); then the
sparse slice at M = 1024 inducing inputs (gpc_tpu's bench.py:279),
cmpnd(rbf, bias, white): one value_and_grad under DTC and FITC (K1 for
K_uu and K_uf, the M × N solve, V·Vᵀ and their backward) and under PITC
with blocks of M (the batched K1 block Grams, batched Cholesky).  `--sparse` runs the sparse slice alone.
`--ivm` runs the IVM alone, at gpc_tpu's geometry (bench.py:362-377: N =
4096, d = 512, q = 2, cmpnd(rbf, bias, white), Gaussian noise): one
selection pass (the captured step replayed d times) and one IvmServer
batch of 8192 rows.
`--gplvm` runs the GP-LVM alone, at gpc_tpu's geometry (bench.py:309-351:
N = 16384, D = 4, q = 2, cmpnd(rbf, bias, white), PCA latents): one
value_and_grad of its objective under dense (K1 + jitchol), lazy (K1
blocks in the left-looking sweep) and iterative (CG + SLQ over 2048-row K1
blocks, and the blockwise backward).
`--bench` runs the bench evidence engines alone, at gpc_tpu's bench
geometry (bench.py:33-40, 92-94: N = 16384, q = 8, D = 1, rbf + 0.1·I):
one call of each of `bench_candidates()` (gpc_tpu's candidate list,
bench.py:120-131, and the port's additions; chip_smoke.py phase 24 checks
and times the same list).
Prints per stage the wall time (host clock around work that ends in a
synchronize), the time in which the card runs at least one kernel in that
window (the union of the kernels' intervals over all streams, from the
profiler's trace), the blocking host reads by site (utils/profiling's
`host_read.<site>` counters), the program's other counters that moved
(`evidence.inverse_vjp`: dense evidence backwards that formed K⁻¹) and
the kernels that take the most, each with
its device time summed (over several streams such sums may pass the wall:
the streams overlap); writes the full tables to --out.  The port's `gpc.*`
spans are in the trace.  Needs CUDA: it exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch import linalg
from gpc_tpu_torch.models.gp import GP, make_objective, posterior_apply
from gpc_tpu_torch.ops.panel_engine import kern_evidence_panel
from gpc_tpu_torch.serving import GPServer
from gpc_tpu_torch.utils.profiling import counts

M_SPARSE = 1024     # inducing inputs: gpc_tpu's sparse record (bench.py:279)
BENCH_HYP = (1.0, 1.0, 0.1)   # inverse width, variance, noise: SNR 10 (bench.py:92-94)
K1, K3, K5 = "dist_gram", "panel_state_rbf", "chol_inv_block"


def bench_data(n=16384, q=8, device="cuda"):
    """gpc_tpu's bench inputs (bench.py:37-40): X (n, q) and m (n, 1) ~
    N(0, 1) from default_rng(0), float32."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((n, q)), dtype=torch.float32, device=device)
    m = torch.tensor(rng.standard_normal((n, 1)), dtype=torch.float32, device=device)
    return X, m


def bench_candidates(hyp=BENCH_HYP):
    """[(name, fn(X, m) → (logdet, quad), bf16, the kernels a call launches)]:
    gpc_tpu's bench candidates (bench.py:120-131) and the port's additions:
    K5 leaves in the flat schedule at base 512 and 1024, the two rbf lazy
    recursions in float32, and the dense evidence through chol_blocked's
    recursion, with and without the K5 leaf-inverse recursion
    (GPC_TPU_PALLAS_BASE), beside torch.linalg.cholesky_ex."""
    from gpc_tpu_torch.ops import chol_blocked
    from gpc_tpu_torch.ops.chol_panel import evidence_panel_rbf
    from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_flat, evidence_left_fast
    from gpc_tpu_torch.ops.lazy_evidence import (evidence_fused_lazy, rbf_block_fn,
                                                 rbf_evidence_lazy)
    iw, var, noise = hyp

    def sweep(engine, pol):
        return lambda X, m: engine(rbf_block_fn(X, iw, var, noise), X.shape[0], m, pol)

    def dense(factor):
        def run(X, m):
            n = X.shape[0]
            L = factor(rbf_block_fn(X, iw, var, noise)(0, 0, n, n))
            v = torch.linalg.solve_triangular(L, m, upper=False)
            return 2.0 * torch.sum(torch.log(torch.diagonal(L))), torch.sum(v * v)
        return run

    return [
        ("panel-b512", lambda X, m: evidence_panel_rbf(X, m, iw, var, noise, b=512), True, (K3,)),
        ("flat-b512", sweep(evidence_flat, Policy(512, True, "xla", True)), True, (K1,)),
        ("flat-b512h", sweep(evidence_flat, Policy(512, True, "xla", True, panelhalf=True)),
         True, (K1,)),
        ("flat-b1024h", sweep(evidence_flat, Policy(1024, True, "xla", True, panelhalf=True)),
         True, (K1,)),
        ("flat-b512-noinv", sweep(evidence_flat, Policy(512, True, False, True)), True, (K1,)),
        ("xla-b512", sweep(evidence_left_fast, Policy(512, True, "xla", True)), True, (K1,)),
        ("flat-b512-k5", sweep(evidence_flat, Policy(512, True, "pallas", True)), True, (K1, K5)),
        ("flat-b1024-k5", sweep(evidence_flat, Policy(1024, True, "pallas", True)), True,
         (K1, K5)),
        ("rbf_evidence_lazy", lambda X, m: rbf_evidence_lazy(X, m, iw, var, noise), False, (K1,)),
        ("evidence_fused_lazy",
         lambda X, m: evidence_fused_lazy(rbf_block_fn(X, iw, var, noise), X.shape[0], m)[:2],
         False, (K1,)),
        ("chol_blocked", dense(lambda K: chol_blocked._cholesky(K, False, leafinv=False)),
         False, (K1,)),
        ("chol_blocked-k5", dense(lambda K: chol_blocked._cholesky(K, False, leafinv=True)),
         False, (K1, K5)),
        ("cholesky_ex", dense(lambda K: torch.linalg.cholesky_ex(K)[0]), False, (K1,)),
    ]


def trace_kernels(prof):
    """[(kernel name, stream, start µs, end µs)] of every kernel the card
    ran in the profiler's window, from its trace.  key_averages() drops
    some kernels that the C library launches on its own streams (K3's);
    the trace keeps them.  A kernel launched early by programmatic
    dependent launch (K3's) starts while the one before it on its stream
    runs and waits for it, so each launch's time here starts where the one
    before it on its stream ended: the kernels of one stream never
    overlap, and their sum over several streams may exceed the wall by the
    overlap between streams."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    out, stream_end = [], {}
    for e in kernels:
        stream = e.get("args", {}).get("stream")
        end = e["ts"] + e["dur"]
        start = max(e["ts"], stream_end.get(stream, e["ts"]))
        stream_end[stream] = max(end, stream_end.get(stream, end))
        out.append((e["name"], stream, start, max(start, end)))
    return out


def busy_us(clipped) -> float:
    """µs in which at least one kernel runs: the measure of the union of
    the kernels' intervals over all streams, never their sum."""
    busy, end = 0.0, None
    for a, b in sorted((a, b) for _, _, a, b in clipped):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy


def stage(name, fn, report):
    fn()
    torch.cuda.synchronize()
    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    changed = {k: v - before.get(k, 0) for k, v in counts().items() if v != before.get(k, 0)}
    reads = {k[len("host_read."):]: d for k, d in changed.items() if k.startswith("host_read.")}
    others = {k: d for k, d in changed.items() if not k.startswith("host_read.")}
    kernels = trace_kernels(prof)
    by_kernel = {}
    for key, stream, a, b in kernels:
        by_kernel.setdefault((key, stream), []).append(b - a)
    rows = sorted(by_kernel.items(), key=lambda kv: sum(kv[1]), reverse=True)
    busy_ms = busy_us(kernels) / 1e3
    head = (f"{name}: wall {wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} % of the wall), host reads "
            f"{sum(reads.values())} {reads}, counters {others}")
    print(head)
    lines = [f"{sum(us) / 1e3:10.3f} ms  x{len(us):<5d} median {np.median(us):9.2f} us  "
             f"stream {stream}  {key}" for (key, stream), us in rows]
    for line in lines[:6]:
        print("    " + line[:150])
    report.append(f"== {head}\n" + "\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--q", type=int, default=8)
    ap.add_argument("--sparse", action="store_true", help="the sparse slice alone")
    ap.add_argument("--ivm", action="store_true", help="the IVM alone")
    ap.add_argument("--gplvm", action="store_true", help="the GP-LVM alone")
    ap.add_argument("--bench", action="store_true", help="the bench evidence engines alone")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_slice: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(0)
    X = rng.standard_normal((args.n, args.q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((args.n, 1))
    kern = KM.Cmpnd(input_dim=args.q, components=(
        KM.Rbf(input_dim=args.q), KM.Bias(input_dim=args.q), KM.White(input_dim=args.q)))
    report = []
    if args.bench:
        Xb, mb = bench_data(args.n, args.q)
        for name, fn, _, _ in bench_candidates():
            stage(f"bench evidence {name}, N = {args.n}", lambda: fn(Xb, mb), report)
            torch.cuda.empty_cache()
    elif args.gplvm:
        gplvm_stages(report)
    elif args.ivm:
        ivm_stages(report)
    else:
        if not args.sparse:
            ftc_stages(args, X, y, kern, rng, report)
        for approx in ("dtc", "fitc", "pitc"):
            sparse = GP(kern, X, y, approx=approx, num_active=M_SPARSE, device="cuda")
            vag = sparse.value_and_grad_fn()
            stage(f"value_and_grad {approx}, M = {M_SPARSE}", lambda: vag(sparse.theta), report)
            del sparse, vag
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(report))


def ivm_stages(report):
    """One IVM selection pass and one IvmServer batch at bench.py's IVM
    geometry (N = 4096, d = 512, q = 2)."""
    from gpc_tpu_torch.models.ivm import IVM
    from gpc_tpu_torch.noise import GaussianNoise
    from gpc_tpu_torch.serving import IvmServer
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4096, 2)).astype(np.float32).astype(np.float64)
    y = np.sin(2 * X[:, :1])
    kern = KM.Cmpnd(input_dim=2, components=(
        KM.Rbf(input_dim=2), KM.Bias(input_dim=2), KM.White(input_dim=2)))
    model = IVM(kern, GaussianNoise(output_dim=1), X, y, num_active=512, device="cuda")
    stage("IVM selection pass, N = 4096, d = 512", model.init_and_select, report)
    server = IvmServer(model, chunk=8192)
    Xt = torch.tensor(rng.standard_normal((8192, 2)), dtype=torch.float32, device="cuda")
    stage("IvmServer batch 8192, d = 512", lambda: server._apply(Xt), report)


def gplvm_stages(report):
    """One GP-LVM value_and_grad per engine at bench.py's GP-LVM geometry."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.models.gplvm import GPLVM
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((16384, 2))
    W = rng.standard_normal((2, 4))
    Y = (np.tanh(Z @ W) + 0.1 * rng.standard_normal((16384, 4))).astype(np.float32)
    kern = KM.Cmpnd(input_dim=2, components=(
        KM.Rbf(input_dim=2), KM.Bias(input_dim=2), KM.White(input_dim=2)))
    model = GPLVM(kern, Y.astype(np.float64), latent_dim=2, device="cuda")
    nlml = model.objective()

    def value_and_grad():
        th = as_tensor(model.theta, model.device).requires_grad_(True)
        return torch.autograd.grad(nlml(th), th)

    for engine in ("dense", "lazy", "iterative"):
        os.environ["GPC_TPU_EVIDENCE"] = engine
        try:
            stage(f"GP-LVM value_and_grad {engine}, N = 16384, D = 4, q = 2", value_and_grad,
                  report)
        finally:
            os.environ.pop("GPC_TPU_EVIDENCE")
        torch.cuda.empty_cache()


def ftc_stages(args, X, y, kern, rng, report):
    """The FTC stages: evidence, serving and value_and_grad (rbf, mlp)."""
    model = GP(kern, X, y, device="cuda")
    theta, Xd, yd, bias, scales = model._args()
    _, kp, _, _ = model.spec.unpack(theta)
    m = (yd - bias) / scales
    Xt = torch.tensor(rng.standard_normal((8192, args.q)), dtype=torch.float32,
                      device="cuda")
    stage("panel evidence (K3)", lambda: kern_evidence_panel(kern, kp, Xd, m), report)
    stage("dense evidence", lambda: linalg.evidence_terms(kern.gram(kp, Xd), m), report)
    server = GPServer(model, chunk=8192, explicit_inverse=True)
    stage("GPServer factor", lambda: server.refresh(model), report)
    stage("GPServer batch 8192", lambda: posterior_apply(model.spec, server.state, Xt), report)
    del server
    torch.cuda.empty_cache()
    nlml = make_objective(model.spec, Xd, yd, bias, scales)

    def value_and_grad(engine):
        os.environ["GPC_TPU_EVIDENCE"] = engine
        try:
            th = theta.clone().requires_grad_(True)
            return torch.autograd.grad(nlml(th), th)
        finally:
            os.environ.pop("GPC_TPU_EVIDENCE")

    for engine in ("dense", "panel"):
        stage(f"value_and_grad {engine}", lambda: value_and_grad(engine), report)
    del model, nlml
    torch.cuda.empty_cache()
    mlp = GP(KM.Cmpnd(input_dim=args.q, components=(
        KM.Mlp(input_dim=args.q), KM.Bias(input_dim=args.q), KM.White(input_dim=args.q))),
        X, y, device="cuda")
    theta, Xd, yd, bias, scales = mlp._args()
    nlml = make_objective(mlp.spec, Xd, yd, bias, scales)
    for engine in ("dense", "lazy"):
        stage(f"value_and_grad {engine}, mlp", lambda: value_and_grad(engine), report)


if __name__ == "__main__":
    main()
