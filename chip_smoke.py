"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of gpc_tpu_torch/csrc/ (nvcc, sm_90a),
holds each kernel against its plain PyTorch version at the shapes the main
path gives it, then runs the FTC inference slice at N = 16384, q = 8 with
the CLI default kernel cmpnd(rbf, bias, white): the gp CLI's log-likelihood
under GPC_TPU_EVIDENCE=panel and dense, predict and test, and a GPServer
answering three requests.  Every check that fails raises, and the script
exits non-zero; it exits non-zero without a result when no CUDA device is
present.  The line before the last is a JSON summary of the kernels; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, Q, CHUNK = 16384, 8, 8192
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of `fn` in ms over `reps` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_build(cuda_lib):
    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"phase 1 build: ok, nvcc {cuda_lib.build_seconds} s, "
        f"build+load {time.perf_counter() - t0:.3f} s")


def phase_gram(dev, rng):
    from gpc_tpu_torch.ops.gram import dist_gram, dist_gram_plain
    X1 = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    X2 = torch.tensor(rng.standard_normal((CHUNK, Q)), dtype=torch.float32, device=dev)
    var = 1.3
    params = {"rbf": [0.7, var], "exp": [0.7, var], "ratquad": [1.5, 0.8, var],
              "matern32": [0.9, var], "matern52": [0.9, var]}
    worst = 0.0
    for family, p in params.items():
        got = dist_gram(family, p, X1, X2)
        want = dist_gram_plain(family, p, X1, X2)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        # both f32, differing only in summation order
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6 * var),
              f"K1 {family} disagrees with its plain version (max abs {err})")
        log(f"phase 2 K1 {family} {N}x{CHUNK}x{Q}: max abs err {err}")
        del got, want
    ms, plain_ms = paired_ms(lambda: dist_gram("rbf", params["rbf"], X1, X2),
                             lambda: dist_gram_plain("rbf", params["rbf"], X1, X2), 10)
    log(f"phase 2 K1 rbf {N}x{CHUNK}: kernel {ms} ms, plain {plain_ms} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def phase_leaf(dev, rng):
    from gpc_tpu_torch.ops.chol_panel import factor_diag, factor_diag_plain
    worst = 0.0
    for b in (128, 256):
        Z = torch.tensor(rng.standard_normal((16, b, b)), dtype=torch.float32, device=dev)
        A = Z @ Z.mT / b + 0.5 * torch.eye(b, device=dev)
        M, ld = factor_diag(A)
        M_p, ld_p = factor_diag_plain(A)
        L = torch.linalg.cholesky(A)
        ld_rel = float(((ld - ld_p).abs() / ld_p.abs()).max())
        resid = float((M @ L - torch.eye(b, device=dev)).abs().max())
        err = float((M - M_p).abs().max())
        worst = max(worst, err)
        check(ld_rel < 1e-4, f"K2 b={b} logdet off by {ld_rel} relative")
        check(resid < 1e-3, f"K2 b={b} max |M L - I| = {resid}")
        log(f"phase 3 K2 b={b} x16: logdet rel {ld_rel}, max|M L - I| {resid}, "
            f"max|M - M_plain| {err}")
    A1 = A[:1, :128, :128].contiguous()      # the main path's one 128-block
    ms, plain_ms = paired_ms(lambda: factor_diag(A1),
                             lambda: factor_diag_plain(A1), 50)
    log(f"phase 3 K2 one 128-block: kernel {ms} ms, plain {plain_ms} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def phase_panel(dev):
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    m = torch.tensor(rng.standard_normal((N, 1)), dtype=torch.float32, device=dev)
    rhs = torch.cat([m, torch.ones_like(m)], dim=1).contiguous()   # D = 2
    args = (X, rhs, 1.0, 1.0, 0.1)
    ld, G, v, _T = panel_state_rbf(*args)
    ld_p, G_p, v_p, _Tp = panel_state_rbf_plain(*args)
    ld_rel = abs(float(ld) - float(ld_p)) / abs(float(ld_p))
    g_rel = float(((torch.diagonal(G) - torch.diagonal(G_p)).abs()
                   / torch.diagonal(G_p).abs()).max())
    err = max(abs(float(ld) - float(ld_p)), float((G - G_p).abs().max()))
    # the bf16 L buffer and Schur GEMMs: gpc_tpu's own bound
    check(ld_rel < 2e-3, f"K3 logdet off by {ld_rel} relative")
    check(g_rel < 2e-3, f"K3 diag(G) off by {g_rel} relative")
    check(bool(torch.isfinite(v).all()), "K3 v not finite")
    log(f"phase 4 K3 N={N} D=2: logdet {float(ld)} vs {float(ld_p)} "
        f"(rel {ld_rel}), diag(G) rel {g_rel}")
    del _T, _Tp, v, v_p
    ms, plain_ms = paired_ms(lambda: panel_state_rbf(*args),
                             lambda: panel_state_rbf_plain(*args), 3)
    log(f"phase 4 K3 N={N}: kernel {ms} ms, plain {plain_ms} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def run_cli(argv, evidence=None):
    """The port's gp CLI in-process; returns its standard output."""
    from gpc_tpu_torch.cli import gp as gp_cli
    old = os.environ.get("GPC_TPU_EVIDENCE")
    if evidence is not None:
        os.environ["GPC_TPU_EVIDENCE"] = evidence
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            gp_cli.main(argv)
    finally:
        if old is None:
            os.environ.pop("GPC_TPU_EVIDENCE", None)
        else:
            os.environ["GPC_TPU_EVIDENCE"] = old
    return out.getvalue()


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def default_kern(q):
    from gpc_tpu_torch import kernels as KM
    return KM.Cmpnd(input_dim=q, components=(
        KM.Rbf(input_dim=q), KM.Bias(input_dim=q), KM.White(input_dim=q)))


def phase_reference(dev):
    """Small input: the card's f32 evidence (panel and dense) against the
    CPU float64 dense route, the port's parity path with gpc_tpu."""
    from gpc_tpu_torch.models.gp import GP
    rng = np.random.default_rng(SEED + 1)
    X = rng.standard_normal((500, Q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((500, 1))
    ref = GP(default_kern(Q), X, y, device="cpu").log_likelihood()
    for evidence in ("dense", "panel"):
        os.environ["GPC_TPU_EVIDENCE"] = evidence
        try:
            got = GP(default_kern(Q), X, y, device=dev).log_likelihood()
        finally:
            os.environ.pop("GPC_TPU_EVIDENCE")
        rel = abs(got - ref) / abs(ref)
        check(rel < 2e-3, f"{evidence} on the card vs CPU f64: rel {rel}")
        log(f"phase 5 reference N=500 {evidence}: {got} vs CPU f64 {ref} (rel {rel})")


def phase_slice(dev, workdir):
    from gpc_tpu_torch.io import model_io
    from gpc_tpu_torch.io.svml import write_svml
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.serving import GPServer

    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((N, Q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((N, 1))
    data = os.path.join(workdir, "train.svml")
    model_file = os.path.join(workdir, "gp_model")
    write_svml(data, X, y)
    model_io.write_gp(model_file, GP(default_kern(Q), X, y, device="cpu"))

    out_panel, panel_ms = timed(lambda: run_cli(["log-likelihood", data, model_file], "panel"))
    out_dense, dense_ms = timed(lambda: run_cli(["log-likelihood", data, model_file], "dense"))
    ll_panel = float(out_panel.split(":")[-1])
    ll_dense = float(out_dense.split(":")[-1])
    rel = abs(ll_panel - ll_dense) / abs(ll_dense)
    check(np.isfinite(ll_panel) and np.isfinite(ll_dense), "log-likelihood not finite")
    check(rel < 2e-3, f"panel vs dense log-likelihood: rel {rel}")
    log(f"phase 5 CLI log-likelihood N={N}: panel {ll_panel} ({panel_ms} ms "
        f"CLI wall), dense {ll_dense} ({dense_ms} ms CLI wall), rel {rel}")

    preds = os.path.join(workdir, "preds")
    run_cli(["predict", data, model_file, preds])
    mu_file = np.loadtxt(preds).reshape(-1, 1)
    check(mu_file.shape == (N, 1) and np.isfinite(mu_file).all(), "predict output")
    mse = float(run_cli(["test", data, model_file]).split(":")[-1])
    check(np.isfinite(mse) and abs(mse - np.mean((y - mu_file) ** 2)) < 1e-4 * (1 + mse),
          f"test MSE {mse} disagrees with the predict file")
    log(f"phase 5 CLI predict/test N={N}: MSE {mse}")

    model = model_io.read_gp(model_file, X=X, y=y, device=dev)
    evidence_ms = {"panel": [], "dense": []}
    for engine in ("panel", "dense", "dense", "panel", "panel", "dense"):
        os.environ["GPC_TPU_EVIDENCE"] = engine
        try:
            ll, ms = timed(model.log_likelihood)
        finally:
            os.environ.pop("GPC_TPU_EVIDENCE")
        check(np.isfinite(ll), f"{engine} log-likelihood not finite")
        evidence_ms[engine].append(ms)
    evidence_ms = {k: float(np.median(v)) for k, v in evidence_ms.items()}
    log(f"phase 5 evidence N={N} (median of 3 GP.log_likelihood calls): "
        f"panel {evidence_ms['panel']} ms, dense {evidence_ms['dense']} ms")

    server, factor_ms = timed(lambda: GPServer(model, chunk=CHUNK, explicit_inverse=True))
    requests = [rng.standard_normal((t, Q)) for t in (CHUNK, 1000, 37)]
    served, serve_ms = timed(lambda: [server.predict(r) for r in requests])
    for Xt, (mu, var) in zip(requests, served):
        want_mu, want_var = model.predict(Xt)
        check(mu.shape == (Xt.shape[0], 1) and var.shape == mu.shape, "server shapes")
        check(np.isfinite(mu).all() and np.isfinite(var).all(), "server output not finite")
        check((var >= 0).all(), "negative predictive variance")
        for name, got, want in (("mean", mu, want_mu), ("variance", var, want_var)):
            err = float(np.abs(got - want).max() / np.abs(want).max())
            check(err < 1e-4, f"server {name} vs GP.predict: rel {err} (T={Xt.shape[0]})")
    n_pred = sum(r.shape[0] for r in requests)
    log(f"phase 5 GPServer N={N} chunk={CHUNK}: factor {factor_ms} ms, "
        f"{n_pred} predictions in {serve_ms} ms = {n_pred / serve_ms * 1e3} predictions/s")
    return dict(evidence_ms=evidence_ms, factor_ms=factor_ms,
                predictions_per_s=n_pred / serve_ms * 1e3)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from gpc_tpu_torch.ops import cuda_lib
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    rng = np.random.default_rng(SEED)

    phase_build(cuda_lib)
    k1 = phase_gram(dev, rng)
    k2 = phase_leaf(dev, rng)
    k3 = phase_panel(dev)
    torch.cuda.empty_cache()
    phase_reference(dev)

    cuda_lib.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as workdir:
        phase_slice(dev, workdir)
    launches = dict(cuda_lib.LAUNCHES)
    log(f"main-path launches: {launches}")
    for name in ("dist_gram", "factor_diag", "panel_state_rbf"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")

    kernels = [
        dict(name="dist_gram", route="cuda", source="gpc_tpu_torch/csrc/gram.cu",
             replaces="gpc_tpu/ops/gram_pallas.py:89", launches=launches["dist_gram"], **k1),
        dict(name="factor_diag", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_panel.py:209", launches=launches["factor_diag"], **k2),
        dict(name="panel_state_rbf", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_panel.py:790",
             launches=launches["panel_state_rbf"], **k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
