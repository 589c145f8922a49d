"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of gpc_tpu_torch/csrc/ (nvcc, sm_90a),
holds each kernel against its plain PyTorch version at the shapes the main
path gives it, then runs the slices at N = 16384, q = 8.  Inference, with
the CLI default kernel cmpnd(rbf, bias, white): the gp CLI's log-likelihood
under GPC_TPU_EVIDENCE=panel and dense, predict and test, and a GPServer
answering three requests.  Training, same kernel: the objective's gradient
on the card against the CPU float64 route (N = 500) and panel against dense
(N = 16384), value_and_grad and SCG timings, and the gp CLI's learn -# 3 /
display / log-likelihood / relearn -# 1 under dense and panel.  The kernel
zoo, with cmpnd(mlp, bias, white): learn -# 3, log-likelihood under dense,
lazy and panel (which falls back to lazy), predict, a GPServer, and
learn -# 1 -k poly -i 1 (polyard) at N = 4096; then the lazy engine's
left-looking sweep with K5 leaves (the default Policy), and the mlp
value_and_grad timings under dense and lazy.  Then the Cholesky leaves at
any size: K5 at ragged n and K6 (chol_block) against their plain versions
in phase 3, evidence_left_fast at N = 10000 (the slice's first 10000 rows,
64 ragged K5 leaves of 156 and 157) against Cholesky leaves, and chol_block
as a standalone op on an mlp Gram block; and the Hopper probes: K7, the
whole evidence in one launch, at N = 16384 in its five modes against the
plain version, the dense f32 evidence and K3, and K8a, the overlap probes
at the TPU probe's shapes on leaf128 and wgmma/TMA: µs a dot (with and
without its K split, and the SMs it holds), a leaf, a slab and each leaf
part beside its bound (one SM's share for the one-block parts; over 105 %
fails), inter / max and seq / sum, and torch.matmul on one dot's and on
gemm512's operands (phase 14); K8b and K8c, the chained bf16 dots of the TPU
probes in three operand forms and four read patterns on wgmma, beside
one torch.matmul a dot, each product's share of its bound (over 105 %
fails) (phase 15); and K8d, the exp tile, the rbf Gram tile,
the matvec chain and the staged bf16 store in its bulk and direct modes
(phase 16).  Phase 17, the sparse slice at gpc_tpu's geometry (N = 16384,
M = 1024, q = 8): DTC, DTCVAR, FITC and PITC (blocks of 1024 and of 1000)
at β = 1, and DTC and FITC at β = 1e3, against the CPU float64 route
(beside a TF32 control), their gradients at N = 2048, M = 128, evidence and
value_and_grad timings, learn -A dtc|fitc -a 1024, display,
log-likelihood, predict and relearn -O quasinew through the CLI (the
learned models against the CPU float64 route), a sparse GPServer, gp
gnuplot on a 1-D DTC model and a -k mlp DTC evidence (K4); then, on a path
of their own, learn -O conjgrad|graddesc|quasinew at N = 4096 (FTC); then
K1, K4 and the batched K1 of PITC's blocks at the sparse shapes against
their plain versions.  Phase 18, the IVM at gpc_tpu's geometry (N = 4096,
d = 512, q = 2): the selection pass (its step captured in a CUDA graph)
with points/s, its K1 launches and the card's order replayed through the
CPU float64 step; probit classification through the ivm CLI (learn -k
rbf, test, class-one-probabilities, predict, display, gnuplot, a learn on
the default lin, which is K4) against the CPU float64 route; -o ncnm with
80 % of the labels blanked; an IvmServer; gp gnuplot on a GP model file
with probit noise; and K1/K4 at the IVM path's shapes.  Phase 19, the
GP-LVM at gpc_tpu's geometry (N = 16384, D = 4, q = 2, bench.py:309-351):
the objective and value_and_grad under dense, lazy (K5 leaves for the
objective alone) and panel, against the CPU float64 route on the first
2048 rows and lazy against dense; panel's bf16 factor on the GP-LVM's own
latents and, inside its domain, on the latents ×4; 10 SCG iterations under
lazy; gplvm learn -# 10 / display / gnuplot through the CLI, -c rbf, -I
rand, -k mlp and the GPDM (-D rbf) at N = 4096, the GPDM also under
iterative.
Phase 20, the matrix-free iterative engine at N = 16384: the FTC and the
GP-LVM evidence and value_and_grad, and the masked form with breaks,
against float64.  Then K1 at the GP-LVM's shapes and K3 against the plain
route of its bf16 policy on the GP-LVM's evidence.  Phase 21, the host and
interop surface on the slice's data: the native and Python SVM-light
readers (bit for bit, and their share of a one-shot `gp learn -# 3`),
learn -f 1 from a .mat against -f 0, .mat round trips of an FTC and a DTC
(M = 1024) model, fgp (train, retrain, query of 8192 rows against
GP.predict) and the daemon (learn -# 3 and log-likelihood through the
client, twice, byte for byte the one-shot CLI's).  Phase 22, the
distributed layer at world size 1 on NCCL, its group started here from a
file store: make_dist_objective for FTC and DTC, DTCVAR, FITC (M = 1024)
against the single-process model, 3 SCG iterations of make_dist_train_step,
GPServer(mesh=) against GPServer, load_svml_sharded against read_svml.
Phase 23, the rest of the distributed layer in the same group: dist_ftc
(evidence_distributed's panel sweep) and its posterior, dist_gplvm (plain
at N = 16384; GPDM and back-constrained at 4096), dist_iterative on the
single process's probes, dist_ivm's order against the graph's (N = 4096,
d = 512), DTC/DTCVAR/FITC on mesh_2d(1, 1) at M = 1024 against the CPU
float64 route, scaling_bench's run and census.  Then two ranks on the one
card over gloo with CUDA tensors (child processes, `chip_smoke.py
--gloo-rank R STORE REFS`): phase 22's DTC and FTC, and phase 23's dist_ftc
on two panels, the 2×1 and 1×2 meshes, dist_ivm and scaling_bench at
world 2.  Phase 24, gpc_tpu's bench evidence engines at its bench geometry
(N = 16384, q = 8, D = 1, rbf + 0.1·I, bench.py:33-40, 92-94), uncut: every
candidate of gpc_tpu's bench list (panel-b512, flat-b512, flat-b512h,
flat-b1024h, flat-b512-noinv, xla-b512) and the port's additions (the flat
schedule with K5 leaves at base 512 and 1024, rbf_evidence_lazy and
evidence_fused_lazy in float32, chol_blocked.cholesky with and without the
K5 leaf-inverse recursion beside cholesky_ex), each with its K1, K3 and K5
launches counted around one call alone, timed (median of 3, CUDA events)
and held to the dense float32 evidence and to the CPU float64 route on the
first 2048 rows; K1 and K5 at its shapes against their plain versions; one
value_and_grad of evidence_flat against dense autograd.  The script fails
if the Python SVM-light reader ran in its process.  The Cholesky routines of K2, K3's leaf, K5 and K6 are the
redesigned ones (csrc/chol_tiles.cuh: a 128-leaf by 32-wide sub-panels, a
register-tiled tile GEMM, a multi-block plan for wider blocks), and K1/K4
the column-stripe Gram tile with its parameters on the card: phases 2–3
time them in rounds (median and spread), K2 at b = 128, 256 and 512, K5
and K6 beside their kernels' device time under torch.profiler, K6 beside
torch.linalg.cholesky and cholesky_ex; phase 4 also holds K3's wgmma/TMA
correction kernel alone to the float32 product of its bf16 operands, prints
K3's device time by part (correction, leaf, solve, reduce) against its
wall and the correction's byte floor, and holds K3 at N = 32768 to the dense
f32 and f64 routes.  Each path runs with the launch counts
set to 0 just before it and read just after; in phase 23 each distributed
call is so counted apart from the single-process references beside it,
and each module must launch K1 (the 2-D mesh K4 too).  Every check
that fails raises, and the script exits non-zero;
it exits non-zero without a result when no CUDA device is present.  The
line before the last is a JSON summary of the kernels, the one before it
phase 24's `bench_evidence` record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpc_tpu_torch.probes import cuda_ms, graph_ms, require_card  # noqa: E402

N, Q, CHUNK = 16384, 8, 8192
SEED = 0
D_PANEL = 2          # K3's right-hand sides in phase 4: m and the bias column

# The H100 SXM's published peaks at 700 W (NVIDIA data sheet, dense): HBM
# bytes/s and operations/s by type.  bound_ms is the larger of bytes moved
# (each input read once, each output written once) over HBM_BPS and
# operations over their peak.
HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
# The special-function units (exp) are not on the data sheet: 16 results a
# clock an SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), times the SMs and the SM clock nvidia-smi reports;
# sfu_peak() computes it for K8d's bounds as PEAK's "sfu" entry.
SFU_PER_CLOCK_SM = 16


def bound(nbytes, ops, peak=PEAK):
    """(bound_ms, bound_by) for `nbytes` moved and `ops` {type: count}."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = sum(n / peak[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sfu_peak():
    """exp results a second: SFU_PER_CLOCK_SM x SMs x clocks.max.sm."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return SFU_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count \
        * float(mhz) * 1e6


def k1_bound(n, m, q):
    """rbf Gram: X1, X2 in, n·m out; per entry a q-dot (2q), the distance
    (3), the scaled exponent (2) and the variance (1)."""
    return bound(4 * (n * q + m * q + n * m), {"f32": n * m * (2 * q + 6)})


def k4_bound(n, m, q):
    """lin/poly/mlp Gram: X1, X2 in, n·m out; per entry a q-dot (2q) and
    the map (about 10: mlp's scale, offset, product, sqrt, divide, clamp,
    arcsin)."""
    return bound(4 * (n * q + m * q + n * m), {"f32": n * m * (2 * q + 10)})


def k5_bound(n):
    """(L, L⁻¹) of one n-block: A in, L and L⁻¹ out; Cholesky and
    triangular inverse, n³/3 each."""
    return bound(4 * 3 * n * n, {"f32": 2 * n ** 3 / 3})


def k6_bound(n):
    """L of one n-block: A in, L out; Cholesky, n³/3."""
    return bound(4 * 2 * n * n, {"f32": n ** 3 / 3})


def k2_bound(b):
    """(L⁻¹, logdet) of one b-block: A in, M out; Cholesky and triangular
    inverse, b³/3 each."""
    return bound(4 * 2 * b * b + 4, {"f32": 2 * b ** 3 / 3})


def k3_bound(n, q, d, b=128):
    """Panel evidence: X, m in; T (bf16), v, G, logdet out.  bf16: the
    Schur corrections (n³/3) and the panel solves (n²·b); f32: the lower
    Gram (n²/2 entries at 2q + 6), the leaves (n/b · 2b³/3) and the
    forward solve (d·n²)."""
    nbytes = 4 * (n * q + n * d) + 2 * n * n + 4 * (d * n + d * d + 1)
    return bound(nbytes, {"bf16": n ** 3 / 3 + n * n * b,
                          "f32": n * n / 2 * (2 * q + 6) + (n // b) * 2 * b ** 3 / 3 + d * n * n})


def k3_byte_floor(n, b=128):
    """Bytes K3's correction streams at panel width b: T[jb:n, :jb] (bf16)
    once per panel, the floor of a correction that does not keep T on chip."""
    return sum(2 * (n - jb) * jb for jb in range(0, n, b))


def k8b_bound(k, b, reps, a_copies=1):
    """Σ of reps (k, b)-contraction bf16 products: the operands (a_copies
    of A, and B) in, (b, b) float32 out; 2 k b² operations a product on
    the tensor cores."""
    return bound(2 * (a_copies + 1) * k * b + 4 * b * b, {"bf16": 2 * k * b * b * reps})


def k8c_bound(k, b, reps, pattern):
    """K8b's work under a read pattern: dynslot reads two copies of A."""
    return k8b_bound(k, b, reps, 2 if pattern == "dynslot" else 1)


def k8d_exp_bound(b, reps, sfu):
    """exp tile: A in, acc out; per element a rep 4 float32 operations (two
    scaled sums) and one exp on the special-function units, which run beside
    the FMA pipes, so the slower of the two bounds it."""
    n = b * b * reps
    return max(bound(8 * b * b, {"f32": 4 * n}), bound(8 * b * b, {"sfu": n}, dict(PEAK, sfu=sfu)))


def k8d_gram_bound(b, reps, sfu, d=8, passes=3):
    """rbf Gram tile: X, n2 in, the tile out.  Per element a rep: one exp on
    the special-function units; 8 float32 operations (the distance, its
    clamp, acc·0 + exp) on the FMA pipes; the d-dot (2d) on the tensor
    cores at the TF32 rate, `passes` times (3: hi·hi + hi·lo + lo·hi, the
    least that keeps it near float32; the kernel runs a fourth, lo·lo).
    Each unit runs beside the others, so the slowest bounds it."""
    n = b * b * reps
    nbytes = 4 * (b * d + b + b * b)
    return max(bound(nbytes, {"sfu": n}, dict(PEAK, sfu=sfu)), bound(nbytes, {"f32": 8 * n}),
               bound(nbytes, {"tf32": passes * 2 * d * n}))


def k8d_matvec_bound(b, reps):
    """reps (b, b)ᵀ·(b, 1) steps: A and v in, v out, 2 b² float32
    operations a step.  In fact latency-bound: each step needs the whole
    previous vector."""
    return bound(4 * (b * b + 2 * b), {"f32": 2 * b * b * reps})


def k8d_store_bound(b, slots=64):
    """The staged store: A (float32) in, big (slots bf16 tiles) and o out,
    each byte once.  The n·2b² bytes a run writes (512 MiB at B = 512, n =
    1024) pass through the 50 MB L2 (big is 32 MiB), which absorbs part of
    them; they lie outside this bound, and phase 16 prints their rate (TB/s
    written) beside it."""
    return bound(4 * b * b + 2 * slots * b * b + 4 * b * b, {})


def log(msg):
    print(msg, flush=True)


def paired_ms(kernel, plain, reps):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def paired_stats(kernel, plain, reps, rounds):
    """Kernel and plain ms over `rounds` rounds of plain, kernel, kernel,
    plain (cuda_ms of `reps` calls each): (median, min, max) of each."""
    ks, ps = [], []
    for _ in range(rounds):
        ps.append(cuda_ms(plain, reps))
        ks += [cuda_ms(kernel, reps), cuda_ms(kernel, reps)]
        ps.append(cuda_ms(plain, reps))
    stat = lambda xs: (float(np.median(xs)), min(xs), max(xs))   # noqa: E731
    return stat(ks), stat(ps)


def kernel_breakdown(fn, reps=3):
    """{kernel name: (device µs per call, launches per call)} of fn under
    torch.profiler, after one warm-up call, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    from gpc_tpu_torch.profile_slice import trace_kernels
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, _, a, b in trace_kernels(prof):
        name = key.replace("(anonymous namespace)::", "").split("(")[0][-40:]
        t, c = out.get(name, (0.0, 0.0))
        out[name] = (t + (b - a) / reps, c + 1 / reps)
    return out


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_build(cuda_lib):
    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"phase 1 build: ok, nvcc {cuda_lib.build_seconds} s, "
        f"build+load {time.perf_counter() - t0:.3f} s")


def phase_gram(dev, rng):
    """K1 against its plain version for its five maps at the serving chunk
    shape (rtol 1e-5), with the parameters on the card as the model passes
    them; rbf timed in 5 rounds of plain, kernel, kernel, plain (20 calls
    each): median and spread."""
    from gpc_tpu_torch.ops.gram import dist_gram, dist_gram_plain
    X1 = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    X2 = torch.tensor(rng.standard_normal((CHUNK, Q)), dtype=torch.float32, device=dev)
    var = 1.3
    params = {f: torch.tensor(p, dtype=torch.float32, device=dev) for f, p in (
        ("rbf", [0.7, var]), ("exp", [0.7, var]), ("ratquad", [1.5, 0.8, var]),
        ("matern32", [0.9, var]), ("matern52", [0.9, var]))}
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
    (ms, lo, hi), (plain_ms, _, _) = paired_stats(
        lambda: dist_gram("rbf", params["rbf"], X1, X2),
        lambda: dist_gram_plain("rbf", params["rbf"], X1, X2), 20, 5)
    log(f"phase 2 K1 rbf {N}x{CHUNK}: kernel median {ms} ms (min {lo}, max {hi}, 10 runs of 20), "
        f"plain median {plain_ms} ms")
    bound_ms, bound_by = k1_bound(N, CHUNK, Q)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_leaf(dev, rng):
    """K2 on 16 jittered SPD blocks at b = 128, 256 and 512: logdet within
    1e-4 relative and ‖ML − I‖ ≤ 1e-3; one 128-block (the main path's leaf)
    timed against its plain version."""
    from gpc_tpu_torch.ops.chol_panel import factor_diag, factor_diag_plain
    worst = 0.0
    for b in (128, 256, 512):
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
        check(not bool(M.triu(1).any()), f"K2 b={b} M not lower triangular")
        log(f"phase 3 K2 b={b} x16: logdet rel {ld_rel}, max|M L - I| {resid}, "
            f"max|M - M_plain| {err}")
    A1 = A[:1, :128, :128].contiguous()      # the main path's one 128-block
    ms, plain_ms = paired_ms(lambda: factor_diag(A1),
                             lambda: factor_diag_plain(A1), 50)
    log(f"phase 3 K2 one 128-block: kernel {ms} ms, plain {plain_ms} ms")
    bound_ms, bound_by = k2_bound(128)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_inner(dev, rng):
    """K4 against its plain version at the serving chunk shape, for lin,
    poly (degree 2, which the kernel multiplies out) and mlp: max abs err
    within 1e-4 of the output's scale (both f32, differing in summation
    order and in the map's intrinsics), the parameters on the card as the
    model passes them.  Each map timed in 5 rounds of plain, kernel,
    kernel, plain (20 calls each), median and spread, and torch.mm(X1, X2ᵀ)
    in the same rounds.  The kernels line gives lin's times (variance 1),
    beside torch.mm, which computes that same function, and the largest
    absolute error of the three maps."""
    from gpc_tpu_torch.ops.gram import inner_gram, inner_gram_plain
    X1 = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    X2 = torch.tensor(rng.standard_normal((CHUNK, Q)), dtype=torch.float32, device=dev)
    params = {f: torch.tensor(p, dtype=torch.float32, device=dev) for f, p in (
        ("lin", [1.0]), ("poly", [0.7, 0.4, 1.3]), ("mlp", [10.0, 10.0, 1.0]))}
    worst, times = 0.0, {}
    for family, p in params.items():
        got = inner_gram(family, p, X1, X2)
        want = inner_gram_plain(family, p, X1, X2)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err)
        check(err <= 1e-4 * scale, f"K4 {family} disagrees with its plain version "
                                   f"(max abs {err}, scale {scale})")
        del got, want
        (k, klo, khi), (pl, _, _) = paired_stats(lambda: inner_gram(family, p, X1, X2),
                                                 lambda: inner_gram_plain(family, p, X1, X2),
                                                 20, 5)
        times[family] = (k, pl)
        log(f"phase 2 K4 {family} {N}x{CHUNK}x{Q}: max abs err {err} (scale {scale}); "
            f"kernel median {k} ms (min {klo}, max {khi}, 10 runs of 20), plain median {pl} ms")
    (library_ms, llo, lhi), _ = paired_stats(lambda: torch.mm(X1, X2.T),
                                             lambda: inner_gram("lin", params["lin"], X1, X2),
                                             20, 5)
    log(f"phase 2 K4 library yardstick torch.mm(X1, X2.T) {N}x{CHUNK}x{Q}: median {library_ms} "
        f"ms (min {llo}, max {lhi}); K4 lin / torch.mm {times['lin'][0] / library_ms}")
    bound_ms, bound_by = k4_bound(N, CHUNK, Q)
    ms, plain_ms = times["lin"]
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms), times


def spd_block(dev, rng, n):
    Z = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
    return Z @ Z.T / n + 0.5 * torch.eye(n, device=dev)


def phase_chol_inv(dev, rng):
    """K5 against its plain version on a jittered SPD block at n = 256 (the
    N = 16384 lazy path's leaf), 1024 (the widest it takes) and the ragged
    157, 192 and 1000 (157 is the N = 10000 path's leaf), which the kernel
    pads to a multiple of 128 with the identity: ‖ML − I‖ ≤ 1e-3 and L
    within 1e-3 of the plain version's largest entry.  Above 1024 it
    raises."""
    from gpc_tpu_torch.ops.chol_pallas import chol_inv_block, chol_inv_block_plain, plan_kernels
    out = {}
    for n in (256, 1024, 157, 192, 1000):
        A = spd_block(dev, rng, n)
        L, M = chol_inv_block(A)
        L_p, _ = chol_inv_block_plain(A)
        resid = float((M @ L - torch.eye(n, device=dev)).abs().max())
        err = float((L - L_p).abs().max())
        scale = float(L_p.abs().max())
        check(resid <= 1e-3, f"K5 n={n}: max |M L - I| = {resid}")
        check(err <= 1e-3 * scale, f"K5 n={n}: L off by {err} (max entry {scale})")
        check(not bool(L.triu(1).any()) and not bool(M.triu(1).any()), "K5 not lower triangular")
        ms, plain_ms = paired_ms(lambda: chol_inv_block(A), lambda: chol_inv_block_plain(A),
                                 5 if n > 512 else 20)
        bound_ms, bound_by = k5_bound(n)
        out[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        log(f"phase 3 K5 n={n}: max|M L - I| {resid}, max|L - L_plain| {err} "
            f"(max entry {scale}); kernel {ms} ms ({plan_kernels(n, True)} kernel launches "
            f"a call), plain {plain_ms} ms, bound {bound_ms} ms ({bound_by})")
        if n == 1000:
            log(f"phase 3 K5 n={n} device time by kernel (us a call, launches a call): "
                f"{kernel_breakdown(lambda: chol_inv_block(A))}")
    try:
        chol_inv_block(torch.eye(1152, device=dev))
        check(False, "K5 took n = 1152")
    except ValueError as e:
        log(f"phase 3 K5 n=1152 raises: {e}")
    return out[157], out


def phase_chol_block(dev, rng):
    """K6 against its plain version, torch.linalg.cholesky (the one call
    that computes the same function), at n = 157, 192, 1000 and 1024: L
    within 1e-3 of the plain version's largest entry, zeros above the
    diagonal.  The library yardstick is the faster of torch.linalg.cholesky
    and cholesky_ex (which skips the host sync on its info flag)."""
    from gpc_tpu_torch.ops.chol_pallas import chol_block, chol_block_plain, plan_kernels
    out = {}
    for n in (157, 192, 1000, 1024):
        A = spd_block(dev, rng, n)
        L = chol_block(A)
        L_p = chol_block_plain(A)
        err = float((L - L_p).abs().max())
        scale = float(L_p.abs().max())
        check(err <= 1e-3 * scale, f"K6 n={n}: L off by {err} (max entry {scale})")
        check(not bool(L.triu(1).any()), "K6 not lower triangular")
        reps = 5 if n > 512 else 20
        ms, plain_ms = paired_ms(lambda: chol_block(A), lambda: chol_block_plain(A), reps)
        chol_ms = cuda_ms(lambda: torch.linalg.cholesky(A), reps)
        chol_ex_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(A), reps)
        library_ms = min(chol_ms, chol_ex_ms)
        bound_ms, bound_by = k6_bound(n)
        out[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)
        log(f"phase 3 K6 n={n}: max|L - L_plain| {err} (max entry {scale}); kernel {ms} ms "
            f"({plan_kernels(n, False)} kernel launches a call), plain {plain_ms} ms, "
            f"torch.linalg.cholesky {chol_ms} ms, cholesky_ex {chol_ex_ms} ms, kernel / faster "
            f"{ms / library_ms}, bound {bound_ms} ms ({bound_by})")
        if n == 1000:   # the leaf's and the one-block tile GEMMs' device time
            log(f"phase 3 K6 n={n} device time by kernel (us a call, launches a call): "
                f"{kernel_breakdown(lambda: chol_block(A))}")
    return out[1000], out


def panel_args(dev):
    """K3's inputs at the main path's shapes: X (N, Q), rhs (N, 2)."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    m = torch.tensor(rng.standard_normal((N, 1)), dtype=torch.float32, device=dev)
    rhs = torch.cat([m, torch.ones_like(m)], dim=1).contiguous()   # D = 2
    return X, rhs, 1.0, 1.0, 0.1


def phase_panel(dev):
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    args = panel_args(dev)
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
    del _Tp, v, v_p
    phase_corr(dev, _T)
    del _T
    ms, plain_ms = paired_ms(lambda: panel_state_rbf(*args),
                             lambda: panel_state_rbf_plain(*args), 3)
    log(f"phase 4 K3 N={N}: kernel {ms} ms, plain {plain_ms} ms")
    by_kernel = kernel_breakdown(lambda: panel_state_rbf(*args), 1)
    log(f"phase 4 K3 N={N} device time by kernel (us a call, launches a call): {by_kernel}")
    parts = {part: sum(us for name, (us, _) in by_kernel.items() if kern in name) / 1e3
             for part, kern in (("correction", "panel_corr"), ("leaf", "panel_leaf"),
                                ("solve", "panel_solve"), ("reduce", "panel_gram"),
                                ("finish", "panel_finish"))}
    busy = sum(us for us, _ in by_kernel.values()) / 1e3
    log(f"phase 4 K3 N={N} device ms by part: {parts}; kernels {busy} ms in a {ms} ms call "
        f"(sum / wall {busy / ms}: above 1 is overlap)")
    bound_ms, bound_by = k3_bound(N, Q, D_PANEL)
    floor = k3_byte_floor(N)
    log(f"phase 4 K3 N={N}: correction byte floor at b=128 {floor / 1e9} GB = "
        f"{floor / HBM_BPS * 1e3} ms; k3_bound {bound_ms} ms ({bound_by}); "
        f"correction {parts['correction']} ms = {floor / parts['correction'] / 1e9} TB/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_corr(dev, T):
    """K3's correction kernel alone on the T of phase 4's K3 call (the bf16
    factor), at the plan's splits and grid for the middle panel's diagonal
    rows and rows below, against the float32 product of the same bf16
    operands: within 1e-4 of Σ|a||b| (the tensor cores' truncating f32 sums
    over the 256 k between register-sum flushes)."""
    from gpc_tpu_torch.ops import chol_panel as CP
    steps = CP.panel_plan(N, torch.cuda.get_device_properties(dev).multi_processor_count)
    j = N // 256
    for st in (s for s in steps if s.kind == CP.FILL and s.j == j):
        args = (T, j * 128, st.row0, st.row1, st.splits)
        got = CP.panel_corr(*args, st.grid)
        want = CP.panel_corr_plain(*args)
        excess = float(((got - want).abs() - 1e-4 * CP.panel_corr_plain(T.abs(), *args[1:]))
                       .max())
        check(excess <= 0, f"K3 correction rows [{st.row0}, {st.row1}) of panel {j}: "
                           f"error above 1e-4 of sum|a||b| by {excess}")
        log(f"phase 4 K3 correction panel {j} rows [{st.row0}, {st.row1}), {st.splits} splits "
            f"on {st.grid} blocks: max abs err {float((got - want).abs().max())} "
            f"(max |want| {float(want.abs().max())})")


N_DRIFT = 32768     # K3's drift check: twice the slice's N; T is 2 GiB of bf16


def phase_panel_drift(dev):
    """K3 at N = 32768 (X ~ N(0, 1), q = 8, rhs = (m, 1)) against the dense
    routes in float32 and float64 (the plain version in each dtype): the
    relative drift of the logdet and of diag(G), held to gpc_tpu's 2e-3
    panel bound; the f32 route's own drift from f64 is printed beside."""
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    rng = np.random.default_rng(SEED + 2)
    X = torch.tensor(rng.standard_normal((N_DRIFT, Q)), dtype=torch.float32, device=dev)
    m = torch.tensor(rng.standard_normal((N_DRIFT, 1)), dtype=torch.float32, device=dev)
    rhs = torch.cat([m, torch.ones_like(m)], dim=1).contiguous()
    (ld, G, _, T), ms = timed(lambda: panel_state_rbf(X, rhs, 1.0, 1.0, 0.1))
    got = (float(ld), torch.diagonal(G).double())
    del T
    torch.cuda.empty_cache()
    dense = {}
    for dtype in (torch.float32, torch.float64):
        ld_d, G_d, _, T_d = panel_state_rbf_plain(X.to(dtype), rhs.to(dtype), 1.0, 1.0, 0.1)
        dense[dtype] = (float(ld_d), torch.diagonal(G_d).double())
        del T_d, G_d
        torch.cuda.empty_cache()

    def drift(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]), float(((a[1] - b[1]).abs() / b[1].abs()).max()))
    out = {"k3_ms": ms}
    for name, (a, b) in (("K3 vs f64", (got, dense[torch.float64])),
                         ("K3 vs f32", (got, dense[torch.float32])),
                         ("f32 vs f64", (dense[torch.float32], dense[torch.float64]))):
        out[name] = drift(a, b)
    for name in ("K3 vs f64", "K3 vs f32"):
        check(max(out[name]) < 2e-3, f"K3 at N={N_DRIFT}, {name}: (logdet, diag G) drift {out[name]}")
    log(f"phase 4 K3 drift N={N_DRIFT} (logdet rel, max diag(G) rel): {out}; K3 {ms} ms "
        f"(first call); the WMMA correction before the wgmma one drifted (1.30e-5, 2.60e-4) "
        f"from f64 (PERF.md §7)")
    return out


def phase_diag(dev):
    """K3 mode "full+diag" at the main path's shapes: T's diagonal blocks
    (bf16 L_jj⁻¹) against the plain version's, within 2e-2 of their max
    (the bf16 rounding of the factor they come from); logdet, G, v and T
    below the blocks equal to mode "full"'s, bit for bit."""
    from gpc_tpu_torch.ops.chol_panel import (diag_blocks, panel_state_rbf,
                                              panel_state_rbf_plain)
    args = panel_args(dev)
    full = panel_state_rbf(*args)
    diag = panel_state_rbf(*args, mode="full+diag")
    for name, a, b in zip(("logdet", "G", "v"), full[:3], diag[:3]):
        check(torch.equal(a, b), f"K3 diag mode changed {name}")
    got = diag_blocks(diag[3]).float()
    check(not bool(diag_blocks(full[3]).any()), "K3 mode full wrote T's diagonal blocks")
    T_rest = diag[3].clone()
    diag_blocks(T_rest).zero_()
    check(torch.equal(T_rest, full[3]), "K3 diag mode changed T below the diagonal blocks")
    del full, diag, T_rest
    want = diag_blocks(panel_state_rbf_plain(*args, mode="full+diag")[3]).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 2e-2 * scale, f"K3 diag blocks off by {err} (max entry {scale})")
    check(not bool(got.triu(1).any()), "K3 diag blocks not lower triangular")
    log(f"phase 4 K3 full+diag N={N}: diag blocks max abs err {err} (max entry {scale}); "
        f"logdet, G, v and T below the blocks equal to mode full")
    del got, want
    ms, plain_ms = paired_ms(lambda: panel_state_rbf(*args, mode="full+diag"),
                             lambda: panel_state_rbf_plain(*args, mode="full+diag"), 3)
    log(f"phase 4 K3 full+diag N={N}: kernel {ms} ms, plain {plain_ms} ms")
    bound_ms, bound_by = k3_bound(N, Q, D_PANEL)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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


def default_kern(q, lead="rbf"):
    """cmpnd(lead, bias, white) at the defaults: the CLI's kernel for
    `-k lead`."""
    from gpc_tpu_torch import kernels as KM
    first = {"rbf": KM.Rbf, "mlp": KM.Mlp}[lead](input_dim=q)
    return KM.Cmpnd(input_dim=q, components=(
        first, KM.Bias(input_dim=q), KM.White(input_dim=q)))


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

    X, y, rng = slice_data()
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


def slice_data():
    """The slice's data: X ~ N(0, 1)^(N×Q), y = sin(ΣX) + 0.1ε, seed SEED."""
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((N, Q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((N, 1))
    return X, y, rng


def with_evidence(engine, fn):
    os.environ["GPC_TPU_EVIDENCE"] = engine
    try:
        return fn()
    finally:
        os.environ.pop("GPC_TPU_EVIDENCE")


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_grad_reference(dev):
    """N = 500: θ̄ on the card (K1, and K3 "full+diag" under panel) against
    the CPU float64 dense route; f32 within 1e-3 and the bf16 factor within
    8e-2 in relative L2 (tests/test_panel_engine.py:97-106)."""
    from gpc_tpu_torch.models.gp import GP
    rng = np.random.default_rng(SEED + 1)
    X = rng.standard_normal((500, Q))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((500, 1))
    cpu = GP(default_kern(Q), X, y, device="cpu")
    f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
    for engine, tol in (("dense", 1e-3), ("panel", 8e-2)):
        card = GP(default_kern(Q), X, y, device=dev)
        f, g = with_evidence(engine, lambda: card.value_and_grad_fn()(card.theta))
        rel = rel_l2(g, g_ref)
        check(np.isfinite(f) and np.isfinite(g).all() and np.abs(g).min() > 0,
              f"{engine} gradient on the card not finite or has a zero entry: {g}")
        check(rel < tol, f"{engine} θ̄ on the card vs CPU f64: rel L2 {rel}")
        log(f"phase 6 gradient N=500 {engine}: θ̄ {g.tolist()} vs CPU f64 "
            f"{g_ref.tolist()} (rel L2 {rel})")


def value_and_grad_split(model):
    """(nlml, θ̄, forward ms, backward ms) of one evaluation on the card."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.models.gp import make_objective
    _, X, y, bias, scales = model._args()
    theta = as_tensor(model.theta, model.device).requires_grad_(True)
    nlml = make_objective(model.spec, X, y, bias, scales, model._xu_fixed())
    f, fwd_ms = timed(lambda: nlml(theta))
    (g,), bwd_ms = timed(lambda: torch.autograd.grad(f, theta))
    return float(f.detach()), g.cpu().numpy().astype(np.float64), fwd_ms, bwd_ms


def scg_timed(model, engine, iters):
    """GP SCG from model.theta for `iters` iterations: the result, and per
    iteration (step accepted, curvature probe ran, host ms).  The probe runs
    when the previous step was accepted, so an iteration is two objective
    evaluations or one.  Each ends in the host reading the objective off the
    card, so the host clock spans its device work."""
    from gpc_tpu_torch.optim import scg_checkpointed
    marks, trace = [], []

    def on_checkpoint(it, st):
        marks.append(time.perf_counter())
        trace.append(bool(st["success"]))

    def run():
        vag = model.value_and_grad_fn()
        marks.append(time.perf_counter())
        return scg_checkpointed(vag, model.theta, max_iters=iters, ckpt_every=1,
                                on_checkpoint=on_checkpoint)
    res = with_evidence(engine, run)
    probed = [True] + trace[:-1]
    return res, list(zip(trace, probed, (np.diff(marks[1:], prepend=marks[0]) * 1e3).tolist()))


def phase_train_timing(dev):
    """N = 16384: forward and backward ms of the objective per engine
    (median of 3), panel θ̄ against dense θ̄ (8e-2 relative L2), and
    GP SCG for 20 iterations from the CLI's default start: ms per iteration
    with the curvature probe (two evaluations) and without it (one)."""
    from gpc_tpu_torch.models.gp import GP
    X, y, _ = slice_data()
    out, grads = {}, {}
    for engine in ("dense", "panel"):
        model = GP(default_kern(Q), X, y, device=dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs = [with_evidence(engine, lambda: value_and_grad_split(model)) for _ in range(3)]
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        f, grads[engine] = runs[0][0], runs[0][1]
        check(np.isfinite(f) and np.isfinite(grads[engine]).all(), f"{engine} value_and_grad not finite")
        fwd = float(np.median([r[2] for r in runs]))
        bwd = float(np.median([r[3] for r in runs]))
        res, steps = scg_timed(model, engine, 20)
        check(np.isfinite(res.obj) and res.obj <= f, f"{engine} SCG objective rose: {f} -> {res.obj}")
        two = [ms for _, probe, ms in steps[1:] if probe]   # steps[0] holds the initial evaluation
        one = [ms for _, probe, ms in steps[1:] if not probe]
        out[engine] = dict(forward_ms=fwd, backward_ms=bwd, value_and_grad_ms=fwd + bwd,
                           peak_gib=peak_gib, scg_iters=res.iters, scg_accepted=sum(ok for ok, _, _ in steps),
                           scg_objective=[f, res.obj],
                           scg_ms_probe_and_trial=float(np.median(two)) if two else None,
                           scg_ms_trial_only=float(np.median(one)) if one else None)
        torch.cuda.empty_cache()
        log(f"phase 7 value_and_grad N={N} {engine} (median of 3): forward {fwd} ms, "
            f"backward {bwd} ms; nlml {f}; peak memory above the data {peak_gib} GiB")
        log(f"phase 7 SCG N={N} {engine}, 20 iterations from the CLI defaults: objective "
            f"{f} -> {res.obj}; per iteration (accepted, probe ran, ms): {steps}")
    rel = rel_l2(grads["panel"], grads["dense"])
    check(rel < 8e-2, f"panel θ̄ vs dense θ̄ at N={N}: rel L2 {rel}")
    log(f"phase 7 gradient N={N}: panel θ̄ {grads['panel'].tolist()} vs dense "
        f"{grads['dense'].tolist()} (rel L2 {rel})")
    return out


def learned(out):
    """(final objective, iterations) from the output of gp learn/relearn."""
    line = next(ln for ln in out.splitlines() if ln.startswith("Final objective:"))
    words = line.split()
    return float(words[2]), int(words[4])


def phase_train_cli(dev, workdir):
    """gp learn -# 3, display, log-likelihood and relearn -# 1 at N = 16384
    under dense and panel, through the CLI a user calls."""
    from gpc_tpu_torch.io.svml import read_svml
    from gpc_tpu_torch.models.gp import GP
    data = os.path.join(workdir, "train.svml")      # written by phase_slice
    X, y = read_svml(data)
    out = {}
    for engine, tol in (("dense", 1e-4), ("panel", 2e-3)):
        model = GP(default_kern(Q), X, y, device=dev)
        f0 = with_evidence(engine, lambda: model.value_and_grad_fn()(model.theta)[0])
        model_file = os.path.join(workdir, f"learned_{engine}")
        text, learn_ms = timed(lambda: run_cli(["learn", "-#", "3", data, model_file], engine))
        final, iters = learned(text)
        check(iters == 3 and np.isfinite(final) and final <= f0,
              f"learn under {engine}: {iters} iterations, objective {f0} -> {final}")
        shown = run_cli(["display", model_file])
        check("rbfinverseWidth" in shown and shown.splitlines()[-4:] == text.splitlines()[-5:-1],
              f"display of the learned {engine} model disagrees with learn's summary")
        ll = float(run_cli(["log-likelihood", data, model_file], engine).split(":")[-1])
        rel = abs(ll + final) / abs(final)
        check(rel <= tol, f"{engine} log-likelihood of the learned model {ll} vs -{final}: rel {rel}")
        text2, relearn_ms = timed(lambda: run_cli(
            ["relearn", "-#", "1", data, model_file, model_file + "_re"], engine))
        final2, iters2 = learned(text2)
        check(iters2 == 1 and np.isfinite(final2) and final2 <= final,
              f"relearn under {engine}: objective {final} -> {final2}")
        out[engine] = dict(learn_cli_ms=learn_ms, relearn_cli_ms=relearn_ms,
                           initial=f0, final=final, after_relearn=final2)
        log(f"phase 7 CLI N={N} {engine}: learn -# 3 objective {f0} -> {final} "
            f"({learn_ms} ms CLI wall), log-likelihood {ll} (rel {rel}), "
            f"relearn -# 1 -> {final2} ({relearn_ms} ms CLI wall)")
        torch.cuda.empty_cache()
    return out


def cli_warned(argv, evidence):
    """run_cli, and the texts of the warnings it raised."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_cli(argv, evidence)
    return out, [str(w.message) for w in caught]


def phase_zoo(dev, workdir):
    """The kernel-zoo slice through the CLI at N = 16384 with -k mlp
    (cmpnd(mlp, bias, white)): learn -# 3 under dense; log-likelihood of
    the learned model under dense, lazy and panel (which warns and falls
    back to lazy), lazy within 1e-4 of dense (both f32 without TF32) and
    −(final objective) within 1e-4; predict; a GPServer on the mlp model
    answering the three request sizes; then learn -# 1 -k poly -i 1
    (polyard) at N = 4096 and its model file read back."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.io import model_io
    from gpc_tpu_torch.io.svml import write_svml
    from gpc_tpu_torch.serving import GPServer
    X, y, rng = slice_data()
    data = os.path.join(workdir, "train.svml")       # written by phase_slice
    model_file = os.path.join(workdir, "mlp_model")
    text, learn_ms = timed(lambda: run_cli(["learn", "-k", "mlp", "-#", "3", data, model_file],
                                           "dense"))
    final, iters = learned(text)
    check(iters == 3 and np.isfinite(final), f"learn -k mlp: {iters} iterations, objective {final}")
    shown = run_cli(["display", model_file])
    check("mlpweightVariance" in shown and shown.splitlines()[-6:] == text.splitlines()[-7:-1],
          "display of the learned mlp model disagrees with learn's summary")
    ll, wall = {}, {}
    for engine in ("dense", "lazy", "panel"):
        (out, warned), wall[engine] = timed(lambda: cli_warned(
            ["log-likelihood", data, model_file], engine))
        ll[engine] = float(out.split(":")[-1])
        check(np.isfinite(ll[engine]), f"{engine} log-likelihood not finite")
        if engine == "panel":
            check(any("falling back to the lazy engine" in w for w in warned),
                  f"panel did not warn of its fallback to lazy: {warned}")
    rel = abs(ll["lazy"] - ll["dense"]) / abs(ll["dense"])
    rel_panel = abs(ll["panel"] - ll["lazy"]) / abs(ll["lazy"])
    rel_final = abs(ll["dense"] + final) / abs(final)
    check(rel <= 1e-4, f"lazy vs dense log-likelihood of the mlp model: rel {rel}")
    check(rel_panel <= 1e-6, f"panel (lazy fallback) vs lazy: rel {rel_panel}")
    check(rel_final <= 1e-4, f"log-likelihood {ll['dense']} vs -{final}: rel {rel_final}")
    log(f"phase 8 CLI N={N} -k mlp: learn -# 3 objective -> {final} ({learn_ms} ms CLI wall); "
        f"log-likelihood dense {ll['dense']} ({wall['dense']} ms), lazy {ll['lazy']} "
        f"({wall['lazy']} ms), panel->lazy {ll['panel']} ({wall['panel']} ms); "
        f"lazy vs dense rel {rel}")

    preds = os.path.join(workdir, "mlp_preds")
    run_cli(["predict", data, model_file, preds])
    mu_file = np.loadtxt(preds).reshape(-1, 1)
    check(mu_file.shape == (N, 1) and np.isfinite(mu_file).all(), "mlp predict output")
    model = model_io.read_gp(model_file, X=X, y=y, device=dev)
    server, factor_ms = timed(lambda: GPServer(model, chunk=CHUNK, explicit_inverse=True))
    requests = [rng.standard_normal((t, Q)) for t in (CHUNK, 1000, 37)]
    served, serve_ms = timed(lambda: [server.predict(r) for r in requests])
    _, kp, _, _ = model.spec.unpack(as_tensor(model.theta, model.device))
    for Xt, (mu, var) in zip(requests, served):
        want_mu, want_var = model.predict(Xt)
        check(np.isfinite(mu).all() and np.isfinite(var).all(), "mlp server output not finite")
        check((var >= 0).all(), "negative predictive variance (mlp)")
        # the variance k** − ‖L⁻¹k‖² cancels terms of the prior variance's
        # size, where the f32 explicit inverse and the solve part at 1e-4
        prior = float(model.spec.kern.diag(kp, as_tensor(Xt, model.device)).max())
        for name, got, want, scale in (("mean", mu, want_mu, np.abs(want_mu).max()),
                                       ("variance", var, want_var, prior)):
            err = float(np.abs(got - want).max() / scale)
            check(err < 1e-4, f"mlp server {name} vs GP.predict: {err} of {scale} "
                              f"(T={Xt.shape[0]})")
    n_pred = sum(r.shape[0] for r in requests)
    log(f"phase 8 GPServer -k mlp N={N}: factor {factor_ms} ms, {n_pred} predictions in "
        f"{serve_ms} ms = {n_pred / serve_ms * 1e3} predictions/s")
    del server, model
    torch.cuda.empty_cache()

    small = os.path.join(workdir, "train4096.svml")
    write_svml(small, X[:4096], y[:4096])
    ard_file = os.path.join(workdir, "polyard_model")
    text, ard_ms = timed(lambda: run_cli(
        ["learn", "-k", "poly", "-i", "1", "-#", "1", small, ard_file], "dense"))
    final_ard, iters_ard = learned(text)
    ll_ard = float(run_cli(["log-likelihood", small, ard_file], "dense").split(":")[-1])
    check(iters_ard == 1 and np.isfinite(final_ard), "learn -k poly -i 1")
    check("polyardinputScale" in run_cli(["display", ard_file]), "polyard model file")
    check(abs(ll_ard + final_ard) <= 1e-4 * abs(final_ard),
          f"polyard log-likelihood {ll_ard} vs -{final_ard}")
    log(f"phase 8 CLI N=4096 -k poly -i 1: learn -# 1 objective -> {final_ard} "
        f"({ard_ms} ms CLI wall), log-likelihood {ll_ard}")
    return dict(learn_cli_ms=learn_ms, final=final, ll=ll, ll_cli_ms=wall,
                factor_ms=factor_ms, predictions_per_s=n_pred / serve_ms * 1e3)


M_SPARSE = 1024      # gpc_tpu's sparse geometry (bench.py:277-303): N = 16384, M = 1024
# f32 on the card against the CPU's float64 at the same θ, relative: the
# evidence at β = 1 (SPARSE_TOL) and at any other β (SPARSE_TOL_BETA: the
# error grows with cond(Am)), θ̄ in L2 (SPARSE_GRAD_TOL) and its X_u block
# (SPARSE_XU_TOL).  Each limit sits between the worst reading of the f32
# route and the least of the same route with TF32 products (the control),
# both printed by phase 17 (PERF.md §6); on an H100 80GB HBM3 at 700 W:
# evidence 5.0e-8 / 8.2e-7 at β = 1, 3.5e-7 / 2.5e-6 at other β (1e3 and the
# relearned models); θ̄ 2.1e-7 / 2.0e-5; X_u 2.4e-6 / 8.1e-4.
SPARSE_TOL = 2e-7
SPARSE_TOL_BETA = 1.5e-6
SPARSE_GRAD_TOL = 2e-6
SPARSE_XU_TOL = 4e-5
BETA_LARGE = 1e3     # a noise variance of 1e-3: Am = I/β + V·Vᵀ nearly singular
SPARSE = ("dtc", "dtcvar", "fitc", "pitc")
SPARSE_CASES = ([(a, 0, 1.0) for a in SPARSE] + [("pitc", 1000, 1.0)]
                + [(a, 0, BETA_LARGE) for a in ("dtc", "fitc")])


def sparse_model(X, y, approx, dev, lead="rbf", pitc_block=0, M=M_SPARSE, beta=1.0):
    """A sparse GP at `gp learn`'s start (β = 1 unless given, inducing
    inputs the sorted seeded subset of X) on `dev`."""
    from gpc_tpu_torch.models.gp import GP
    return GP(default_kern(X.shape[1], lead), X, y, approx=approx, num_active=M, seed=SEED,
              pitc_block=pitc_block, beta=beta, device=dev)


def sparse_tol(beta):
    return SPARSE_TOL if beta == 1.0 else SPARSE_TOL_BETA


def sparse_tag(approx, block, beta):
    return (approx + (str(block) if block else "")
            + ("" if beta == 1.0 else f"_beta{beta:g}"))


@contextlib.contextmanager
def tf32_products():
    """The precision control: TF32 for cuBLAS matrix products, which the
    port keeps off (gpc_tpu_torch/__init__.py)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def plain_gram_calls():
    """Counts the plain Gram versions' calls on CUDA tensors (a list of one
    count): 0 on a path that launches K1/K4 for every Gram; the backward of
    K1/K4 recomputes the plain map by design (ops/gram.py)."""
    from gpc_tpu_torch.ops import gram as G
    count = [0]
    saved = G.dist_gram_plain, G.inner_gram_plain

    def counted(fn):
        def wrapper(family, params, X1, *rest):
            count[0] += X1.device.type == "cuda"
            return fn(family, params, X1, *rest)
        return wrapper
    G.dist_gram_plain, G.inner_gram_plain = counted(saved[0]), counted(saved[1])
    try:
        yield count
    finally:
        G.dist_gram_plain, G.inner_gram_plain = saved


def phase_sparse(dev, workdir):
    """Phase 17, the sparse slice at gpc_tpu's geometry: N = 16384, M =
    1024, q = 8, cmpnd(rbf, bias, white) at `gp learn`'s start.  Each
    approximation's f32 evidence against the CPU float64 route at the same
    θ (sparse_tol), PITC in blocks of 1024 and of 1000 (a ragged last
    block of 384), DTC and FITC also at β = 1e3, each beside the TF32
    control; evidence ms and value_and_grad ms (forward / backward, median
    of 3) and peak GiB; the gradient in θ, X_u and β against the CPU float64
    route at N = 2048, M = 128 in the same cases (SPARSE_GRAD_TOL and
    SPARSE_XU_TOL relative L2, beside the control's); no plain Gram runs on
    the forward paths (evidence, log-likelihood, predict, serving; the
    backward of K1/K4 recomputes the plain map by design).  Through the
    CLI: learn -A dtc|fitc -a 1024 -# 3, display, log-likelihood (= −final
    objective within 1e-4), predict, relearn -# 1 -O quasinew (the native
    L-BFGS engine), and the relearned model (its learned β) on the card
    against the CPU float64 route (sparse_tol); a sparse GPServer (factor ms, predictions/s
    at 8192, 1000 and 37 rows, against GP.predict within 1e-4); gp gnuplot
    on a 1-D DTC model at N = 16384; and one DTC evaluation with -k mlp
    (K4)."""
    from gpc_tpu_torch.io import model_io
    from gpc_tpu_torch.io.svml import write_svml
    from gpc_tpu_torch.optim.lbfgs import ENGINE_RUNS
    from gpc_tpu_torch.serving import GPServer
    X, y, rng = slice_data()
    out = {}
    with plain_gram_calls() as plain:
        for approx, block, beta in SPARSE_CASES:
            tag = sparse_tag(approx, block, beta)
            card = sparse_model(X, y, approx, dev, pitc_block=block, beta=beta)
            ref, cpu_ms = timed(sparse_model(X, y, approx, "cpu", pitc_block=block,
                                             beta=beta).log_likelihood)
            runs = [timed(card.log_likelihood) for _ in range(3)]
            ll = runs[0][0]
            rel = abs(ll - ref) / abs(ref)
            with tf32_products():
                rel_tf32 = abs(card.log_likelihood() - ref) / abs(ref)
            check(np.isfinite(ll) and rel < sparse_tol(beta),
                  f"{tag} evidence on the card {ll} vs CPU f64 {ref}: rel {rel}")
            fwd_plain = plain[0]
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            vg = [value_and_grad_split(card) for _ in range(3)]
            peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            check(all(np.isfinite(r[0]) and np.isfinite(r[1]).all() for r in vg),
                  f"{tag} value_and_grad not finite")
            out[tag] = dict(ll=ll, ll_cpu_f64=ref, rel=rel, rel_tf32_control=rel_tf32,
                            cpu_f64_ms=cpu_ms,
                            evidence_ms=float(np.median([r[1] for r in runs])),
                            forward_ms=float(np.median([r[2] for r in vg])),
                            backward_ms=float(np.median([r[3] for r in vg])),
                            peak_gib=peak_gib, plain_calls_forward=fwd_plain,
                            plain_calls_backward=plain[0] - fwd_plain)
            plain[0] = 0
            log(f"phase 17 {tag} N={N} M={M_SPARSE}: evidence {ll} vs CPU f64 {ref} (rel {rel}; "
                f"TF32 control {rel_tf32}); {json.dumps(out[tag])}")
            del card
            torch.cuda.empty_cache()
        check(all(out[t]["plain_calls_forward"] == 0 for t in out),
              "a plain Gram ran on the sparse evidence path")

        Xs, ys = X[:2048], y[:2048]
        grads = {}
        for approx, block, beta in SPARSE_CASES:
            block = 100 if block else 0
            tag = sparse_tag(approx, block, beta)
            cpu = sparse_model(Xs, ys, approx, "cpu", pitc_block=block, M=128, beta=beta)
            card = sparse_model(Xs, ys, approx, dev, pitc_block=block, M=128, beta=beta)
            f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
            f, g = card.value_and_grad_fn()(card.theta)
            with tf32_products():
                _, g_tf32 = card.value_and_grad_fn()(card.theta)
            rel, rel_xu = rel_l2(g, g_ref), rel_l2(g[:-5], g_ref[:-5])
            grads[tag] = dict(rel=rel, rel_xu=rel_xu, rel_tf32_control=rel_l2(g_tf32, g_ref),
                              rel_xu_tf32_control=rel_l2(g_tf32[:-5], g_ref[:-5]))
            check(np.isfinite(g).all() and rel < SPARSE_GRAD_TOL and rel_xu < SPARSE_XU_TOL,
                  f"{tag} gradient N=2048 M=128 vs CPU f64: rel L2 {rel}, X_u {rel_xu}")
            log(f"phase 17 gradient {tag} N=2048 M=128: θ̄ rel L2 {rel} (X_u {rel_xu}, kernel "
                f"{rel_l2(g[-5:-1], g_ref[-5:-1])}, β {g[-1]} vs {g_ref[-1]}); nlml {f} vs "
                f"{f_ref}; TF32 control {json.dumps(grads[tag])}")
        out["gradients_n2048"] = grads

        data = os.path.join(workdir, "train.svml")         # written by phase_slice
        cli = {}
        for approx in ("dtc", "fitc"):
            model_file = os.path.join(workdir, f"{approx}_model")
            text, learn_ms = timed(lambda: run_cli(
                ["-s", str(SEED), "learn", "-A", approx, "-a", str(M_SPARSE), "-#", "3",
                 data, model_file]))
            final, iters = learned(text)
            check(iters == 3 and np.isfinite(final), f"learn -A {approx}: {iters}, {final}")
            shown = run_cli(["display", model_file])
            check(f"Approximation type: {approx}" in shown and "beta: " in shown
                  and shown.splitlines()[-5:] == text.splitlines()[-6:-1],
                  f"display of the learned {approx} model disagrees with learn's summary")
            plain[0] = 0
            ll, ll_ms = timed(lambda: float(run_cli(["log-likelihood", data, model_file])
                                             .split(":")[-1]))
            check(abs(ll + final) <= 1e-4 * abs(final),
                  f"{approx} log-likelihood of the learned model {ll} vs -{final}")
            preds = os.path.join(workdir, f"{approx}_preds")
            run_cli(["predict", data, model_file, preds])
            mu_file = np.loadtxt(preds).reshape(-1, 1)
            check(mu_file.shape == (N, 1) and np.isfinite(mu_file).all(), f"{approx} predict")
            check(plain[0] == 0, f"a plain Gram ran in log-likelihood or predict -A {approx}")
            native = ENGINE_RUNS["native"]
            text2, relearn_ms = timed(lambda: run_cli(
                ["relearn", "-#", "1", "-O", "quasinew", data, model_file, model_file + "_re"]))
            final2, _ = learned(text2)
            check(ENGINE_RUNS["native"] == native + 1, "relearn -O quasinew: native L-BFGS not used")
            check(np.isfinite(final2) and final2 <= final + 1e-5 * abs(final),
                  f"relearn -O quasinew {approx}: {final} -> {final2}")
            learned_card = model_io.read_gp(model_file + "_re", X=X, y=y, device=dev)
            beta = learned_card.beta()
            ll_card = learned_card.log_likelihood()
            with tf32_products():
                ll_tf32 = learned_card.log_likelihood()
            ll_f64 = model_io.read_gp(model_file + "_re", X=X, y=y,
                                      device="cpu").log_likelihood()
            rel = abs(ll_card - ll_f64) / abs(ll_f64)
            rel_tf32 = abs(ll_tf32 - ll_f64) / abs(ll_f64)
            check(np.isfinite(ll_card) and rel < sparse_tol(beta),
                  f"learned {approx} model (β {beta}) on the card {ll_card} vs CPU f64 {ll_f64}")
            del learned_card
            cli[approx] = dict(learn_cli_ms=learn_ms, final=final, ll=ll, ll_cli_ms=ll_ms,
                               relearn_quasinew_cli_ms=relearn_ms, after_relearn=final2,
                               relearned_beta=beta, relearned_ll_cpu_f64=ll_f64,
                               relearned_rel=rel, relearned_rel_tf32_control=rel_tf32)
            log(f"phase 17 CLI -A {approx} -a {M_SPARSE}: {json.dumps(cli[approx])}")
        out["cli"] = cli

        model = model_io.read_gp(os.path.join(workdir, "dtc_model"), X=X, y=y, device=dev)
        plain[0] = 0
        server, factor_ms = timed(lambda: GPServer(model, chunk=CHUNK))
        requests = [rng.standard_normal((t, Q)) for t in (CHUNK, 1000, 37)]
        served, serve_ms = timed(lambda: [server.predict(r) for r in requests])
        for Xt, (mu, var) in zip(requests, served):
            want_mu, want_var = model.predict(Xt)
            check(np.isfinite(mu).all() and (var >= 0).all(), "sparse server output")
            for name, got, want in (("mean", mu, want_mu), ("variance", var, want_var)):
                err = float(np.abs(got - want).max() / np.abs(want).max())
                check(err < 1e-4, f"sparse server {name} vs GP.predict: rel {err}")
        n_pred = sum(r.shape[0] for r in requests)
        out["server"] = dict(factor_ms=factor_ms, serve_ms=serve_ms,
                             predictions_per_s=n_pred / serve_ms * 1e3)
        log(f"phase 17 GPServer DTC N={N} M={M_SPARSE}: factor {factor_ms} ms, {n_pred} "
            f"predictions in {serve_ms} ms = {n_pred / serve_ms * 1e3} predictions/s")
        check(plain[0] == 0, "a plain Gram ran on the sparse serving path")
        del server, model
        torch.cuda.empty_cache()

    rng1 = np.random.default_rng(SEED + 2)
    X1 = rng1.uniform(-3.0, 3.0, (N, 1))
    y1 = np.sinc(X1) + 0.1 * rng1.standard_normal((N, 1))
    data1 = os.path.join(workdir, "train1d.svml")
    write_svml(data1, X1, y1)
    model1 = os.path.join(workdir, "dtc1d_model")
    run_cli(["-s", str(SEED), "learn", "-A", "dtc", "-a", str(M_SPARSE), "-#", "3", data1,
             model1])
    name = os.path.join(workdir, "sinc")
    _, gnuplot_ms = timed(lambda: run_cli(["gnuplot", data1, model1, name]))
    line = np.loadtxt(name + "_line_data.dat")
    bars = np.loadtxt(name + "_error_bar_data.dat")
    active = np.loadtxt(name + "_active_set.dat")
    scatter = np.loadtxt(name + "_scatter_data.dat")
    script = open(name + "_plot.gp").read()
    check(line.shape == (80, 2) and bars.shape == (160, 2) and active.shape == (M_SPARSE, 2)
          and scatter.shape == (N, 2) and np.isfinite(line).all() and np.isfinite(bars).all()
          and (bars[:80, 1] >= line[:, 1]).all() and "sinc_active_set.dat" in script,
          "gnuplot artifacts of the 1-D DTC model")
    out["gnuplot_cli_ms"] = gnuplot_ms
    log(f"phase 17 gnuplot 1-D DTC N={N} M={M_SPARSE}: 5 files in {gnuplot_ms} ms CLI wall; "
        f"mean at the ends {line[0, 1]} .. {line[-1, 1]}")

    mlp = sparse_model(X, y, "dtc", dev, lead="mlp")
    ll, mlp_ms = timed(mlp.log_likelihood)
    ref = sparse_model(X, y, "dtc", "cpu", lead="mlp").log_likelihood()
    rel = abs(ll - ref) / abs(ref)
    check(np.isfinite(ll) and rel < SPARSE_TOL, f"mlp DTC evidence {ll} vs CPU f64 {ref}")
    out["mlp_dtc"] = dict(ll=ll, ll_cpu_f64=ref, rel=rel, evidence_ms=mlp_ms)
    log(f"phase 17 -k mlp DTC N={N} M={M_SPARSE}: evidence {ll} vs CPU f64 {ref} (rel {rel}), "
        f"{mlp_ms} ms (first call)")
    return out


def phase_ftc_optimisers(workdir):
    """learn -# 3 -O conjgrad|graddesc|quasinew on the FTC default at N =
    4096 through the CLI (dense evidence); -O quasinew runs the native
    L-BFGS engine."""
    from gpc_tpu_torch.optim.lbfgs import ENGINE_RUNS
    small = os.path.join(workdir, "train4096.svml")     # written by phase_zoo
    opt = {}
    for optimiser in ("conjgrad", "graddesc", "quasinew"):
        native = ENGINE_RUNS["native"]
        model_file = os.path.join(workdir, f"ftc_{optimiser}")
        text, ms = timed(lambda: run_cli(["learn", "-O", optimiser, "-#", "3", small, model_file],
                                         "dense"))
        final, iters = learned(text)
        check(np.isfinite(final) and 1 <= iters <= 3, f"learn -O {optimiser}: {iters}, {final}")
        if optimiser == "quasinew":
            check(ENGINE_RUNS["native"] == native + 1, "learn -O quasinew: native L-BFGS not used")
        opt[optimiser] = dict(learn_cli_ms=ms, final=final, iters=iters)
    log(f"phase 17 optimisers N=4096 FTC: {json.dumps(opt)}")
    return opt


def graph_paired_ms(kernel, plain, calls=20, rounds=5):
    """(median, min, max) ms a call of kernel and of plain: `calls` calls of
    each captured in one CUDA graph, replayed in `rounds` rounds of plain,
    kernel, kernel, plain, each replay timed by CUDA events."""
    graphs = []
    for fn in (kernel, plain):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                                  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()

    def replay_ms(g):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    ks, ps = [], []
    for _ in range(rounds):
        ps.append(replay_ms(graphs[1]))
        ks += [replay_ms(graphs[0]), replay_ms(graphs[0])]
        ps.append(replay_ms(graphs[1]))
    stat = lambda xs: (float(np.median(xs)), min(xs), max(xs))   # noqa: E731
    return stat(ks), stat(ps)


def phase_sparse_kernels(dev, rng):
    """K1 and K4 (mlp) at the sparse path's cross-Gram K_uf, 1024 × 16384, q
    = 8, and the batched K1 of PITC's 16 blocks of 1024: against their plain
    versions (rtol 1e-5, as phase 2), and timed as 20 calls captured in one
    CUDA graph, replayed in 5 rounds of plain, kernel, kernel, plain (the
    kernels line's ms: every kernel of a call, the parameters' padding
    included, without the host's enqueue of ≈ 60 µs a call, which outlasts
    these kernels); and as 20 calls timed by CUDA events (the host's
    enqueue included)."""
    from gpc_tpu_torch.ops.gram import (dist_gram_kernel, dist_gram_plain, inner_gram_kernel,
                                        inner_gram_plain)
    Xu = torch.tensor(rng.standard_normal((M_SPARSE, Q)), dtype=torch.float32, device=dev)
    X = torch.tensor(rng.standard_normal((N, Q)), dtype=torch.float32, device=dev)
    Xb = X.reshape(N // M_SPARSE, M_SPARSE, Q)
    rbf = torch.tensor([0.7, 1.3], dtype=torch.float32, device=dev)
    mlp = torch.tensor([10.0, 10.0, 1.3], dtype=torch.float32, device=dev)
    P = N // M_SPARSE
    cases = {
        "dist_gram": (lambda: dist_gram_kernel("rbf", rbf, Xu, X),
                      lambda: dist_gram_plain("rbf", rbf, Xu, X), k1_bound(M_SPARSE, N, Q)),
        "inner_gram": (lambda: inner_gram_kernel("mlp", mlp, Xu, X),
                       lambda: inner_gram_plain("mlp", mlp, Xu, X), k4_bound(M_SPARSE, N, Q)),
        "dist_gram_batched": (lambda: dist_gram_kernel("rbf", rbf, Xb, Xb),
                              lambda: dist_gram_plain("rbf", rbf, Xb, Xb),
                              bound(4 * (2 * N * Q + P * M_SPARSE * M_SPARSE),
                                    {"f32": P * M_SPARSE * M_SPARSE * (2 * Q + 6)})),
    }
    res = {}
    for name, (kernel, plain, (bound_ms, bound_by)) in cases.items():
        got, want = kernel(), plain()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max())),
              f"{name} at the sparse shape disagrees with its plain version (max abs {err})")
        if name == "dist_gram_batched":
            check(all(torch.equal(got[b], dist_gram_kernel("rbf", rbf, Xb[b], Xb[b]))
                      for b in range(P)), "batched K1 differs from its 2-D launches")
        del got, want
        (ev_ms, _, _), (ev_plain_ms, _, _) = paired_stats(kernel, plain, 20, 5)
        (ms, lo, hi), (plain_ms, _, _) = graph_paired_ms(kernel, plain)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, events_ms=ev_ms, events_plain_ms=ev_plain_ms)
        log(f"phase 17 {name} at the sparse shape: CUDA graph of 20 calls, median {ms} ms a "
            f"call (min {lo}, max {hi}), plain {plain_ms} ms; CUDA events (host enqueue "
            f"included) {ev_ms} ms, plain {ev_plain_ms} ms; bound {bound_ms} ms ({bound_by}); "
            f"max abs err {err}")
        torch.cuda.empty_cache()
    return res



IVM_N, IVM_D, IVM_Q = 4096, 512, 2     # gpc_tpu's IVM geometry (bench.py:362-377)
# The card's float32 pass against the CPU float64 replay of its order
# (models/ivm.replay): the f64 entropy score of each pick within
# IVM_GAP_TOL of that step's f64 maximum, relative to it, and μ, ς, m̃, β̃
# within IVM_STATE_TOL of each field's largest f64 entry.  From the first
# run's readings (PERF.md §6, PR 9; H100 80GB HBM3, 700 W): 430 of 512
# picks were not the f64 maximum, the worst 4.8e-3 below it, and the state
# within 7.4e-6.  The score's conditioning bounds the gap: with Gaussian
# noise Δ = −½·log(1 − ς·ν), ς·ν = ς/(σ² + ς), and at σ² = 1e-6 float32
# computes 1 − ς·ν to ε₃₂·ς/σ² ≈ 6 % of itself, ≈ 0.03 of Δ ≈ 7 (0.4 %) at
# each of two near-tied points.
IVM_GAP_TOL = 1e-2
IVM_STATE_TOL = 1e-4
IVM_CLI_TOL = 1e-4   # the CLI's f32 log-likelihood against the f64 route, relative


def ivm_select_data():
    """bench.py:366-369: X ~ N(0, 1)^(4096×2) in float32, y = sin(2x₁)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((IVM_N, IVM_Q)).astype(np.float32).astype(np.float64)
    return X, np.sin(2 * X[:, :1]).astype(np.float32).astype(np.float64)


def ivm_class_data():
    """X ~ U[0, 1]², y = sign(x₁ + x₂ − 1) with 5 % of the labels flipped."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (IVM_N, IVM_Q))
    y = np.where(X.sum(axis=1, keepdims=True) > 1.0, 1.0, -1.0)
    flip = rng.permutation(IVM_N)[:IVM_N // 20]
    y[flip] *= -1.0
    return X, y


def run_ivm_cli(argv):
    """The port's ivm CLI in-process; returns its standard output."""
    from gpc_tpu_torch.cli import ivm as ivm_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ivm_cli.main(argv)
    return out.getvalue()


def phase_ivm_select(dev):
    """18(a): the selection pass at bench.py's geometry, N = 4096, d = 512,
    q = 2, cmpnd(rbf, bias, white), Gaussian noise at its defaults, entropy
    selection: points/s (median of 3 passes after a warm-up pass that
    captures the step), the K1 launches of one pass, and the card's order
    replayed through the CPU float64 step (IVM_GAP_TOL, IVM_STATE_TOL)."""
    from gpc_tpu_torch.models.ivm import IVM, replay
    from gpc_tpu_torch.noise import GaussianNoise
    from gpc_tpu_torch.ops import cuda_lib
    X, y = ivm_select_data()
    model = IVM(default_kern(IVM_Q), GaussianNoise(output_dim=1), X, y, num_active=IVM_D,
                device=dev)
    _, capture_ms = timed(model.init_and_select)
    before = cuda_lib.LAUNCHES["dist_gram"]
    runs = [timed(model.init_and_select)[1] for _ in range(3)]
    pass_launches = (cuda_lib.LAUNCHES["dist_gram"] - before) // 3
    check(pass_launches == IVM_D, f"K1 launches a pass: {pass_launches}, want {IVM_D}")
    ms = float(np.median(runs))
    st = model.state
    order = st.active_idx.cpu().numpy()
    check(len(set(order.tolist())) == IVM_D, "the card's pass picked a point twice")
    (ref, gaps), replay_ms = timed(lambda: replay(
        model.spec, model.kern_params, model.noise_params, torch.as_tensor(X),
        torch.as_tensor(y), order))
    errs = {}
    for name in ("mu", "varsigma", "m_site", "beta_site"):
        a = getattr(st, name).double().cpu().numpy()
        b = getattr(ref, name).numpy()
        errs[name] = float(np.abs(a - b).max() / np.abs(b).max())
    out = dict(points_per_s=IVM_D / ms * 1e3, pass_ms=ms, passes_ms=runs,
               first_pass_with_capture_ms=capture_ms, k1_launches_a_pass=pass_launches,
               replay_cpu_f64_ms=replay_ms, worst_gap_rel=float(gaps.max()),
               picks_not_the_f64_max=int((gaps > 0).sum()), state_rel=errs)
    log(f"phase 18 IVM selection N={IVM_N} d={IVM_D}: {json.dumps(out)}")
    check(float(gaps.max()) <= IVM_GAP_TOL,
          f"a pick's f64 score is {float(gaps.max())} (relative) below the step's maximum")
    check(all(e <= IVM_STATE_TOL for e in errs.values()), f"card vs f64 replay: {errs}")
    return out


def cli_number(out, prefix):
    """The number after `prefix` in a CLI's output."""
    line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
    return float(line[len(prefix):].strip().rstrip("%."))


def phase_ivm_cli(dev, workdir):
    """18(b)–(e) through the ivm and gp CLIs at N = 4096, d = 512: (b)
    probit classification, `learn -k rbf -a 512 -# 20 -n 5 -e 2`, then
    test, class-one-probabilities, predict, display and gnuplot, the
    classification error and the model's log-likelihood against the CPU
    float64 route on the same model file, and a short learn on the default
    kernel lin (K4); (c) `-o ncnm` with 80 % of the labels blanked; (d) an
    IvmServer on (b)'s model: factor ms, predictions/s for requests of
    8192, 1000 and 37 rows, mean and variance within 1e-4 of IVM.predict;
    (e) gp gnuplot on a GP model file with probit noise."""
    from gpc_tpu_torch.io import model_io
    from gpc_tpu_torch.io.svml import write_svml
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.serving import IvmServer
    X, y = ivm_class_data()
    data = os.path.join(workdir, "ivm_class.svml")
    write_svml(data, X, y)
    model_file = os.path.join(workdir, "ivm_model")
    out = {}
    text, out["learn_cli_ms"] = timed(lambda: run_ivm_cli(
        ["-s", str(SEED), "learn", "-k", "rbf", "-a", str(IVM_D), "-#", "20", "-n", "5",
         "-e", "2", data, model_file]))
    check(f"Active set size: {IVM_D}" in text, "ivm learn's summary")
    card, cpu = {}, {}
    for route, dest in ((["--device", "cuda"], card), (["--device", "cpu"], cpu)):
        t, ms = timed(lambda: run_ivm_cli(route + ["test", data, model_file]))
        dest["error_pct"], dest["test_cli_ms"] = cli_number(t, "Classification error on output 1:"), ms
        t, ms = timed(lambda: run_ivm_cli(route + ["log-likelihood", data, model_file]))
        dest["ll"], dest["ll_cli_ms"] = cli_number(t, "Model log likelihood:"), ms
    out.update(error_pct=card["error_pct"], error_pct_cpu_f64=cpu["error_pct"], ll=card["ll"],
               ll_cpu_f64=cpu["ll"], ll_rel=abs(card["ll"] - cpu["ll"]) / abs(cpu["ll"]),
               test_cli_ms=card["test_cli_ms"], ll_cli_ms=card["ll_cli_ms"],
               test_cpu_f64_cli_ms=cpu["test_cli_ms"])
    # one point of 4096 may fall on the other side of the decision boundary in f32
    check(abs(card["error_pct"] - cpu["error_pct"]) <= 100.0 / IVM_N + 1e-9,
          f"classification error {card['error_pct']} % vs CPU f64 {cpu['error_pct']} %")
    check(np.isfinite(card["ll"]) and out["ll_rel"] <= IVM_CLI_TOL,
          f"ivm log-likelihood {card['ll']} vs CPU f64 {cpu['ll']}")
    probs = os.path.join(workdir, "ivm_probs")
    preds = os.path.join(workdir, "ivm_preds")
    _, out["class_one_cli_ms"] = timed(lambda: run_ivm_cli(
        ["class-one-probabilities", data, model_file, probs]))
    run_ivm_cli(["predict", data, model_file, preds])
    p1, pred = np.loadtxt(probs).reshape(-1), np.loadtxt(preds).reshape(-1)
    check(p1.shape == (IVM_N,) and ((p1 >= 0) & (p1 <= 1)).all(), "class-one probabilities")
    # out's sign(μ + b) is Φ((μ + b)/√(ς + σ²)) > 0.5 but at a tie in float32
    check(np.sum(pred != np.where(p1 > 0.5, 1.0, -1.0)) <= 1, "predict vs probabilities")
    shown = run_ivm_cli(["display", model_file]).strip()
    check(shown.startswith("IVM Model:") and shown in text, "ivm display vs learn's summary")
    name = os.path.join(workdir, "ivm_plot")
    _, out["gnuplot_cli_ms"] = timed(lambda: run_ivm_cli(["gnuplot", data, model_file, name]))
    grid = np.loadtxt(name + "_prob_matrix.dat")
    check(grid.shape == (80 * 80, 3) and np.isfinite(grid).all(), "ivm gnuplot's grid")

    lin_file = os.path.join(workdir, "ivm_lin")
    text, out["learn_lin_cli_ms"] = timed(lambda: run_ivm_cli(
        ["-s", str(SEED), "learn", "-a", str(IVM_D), "-#", "3", "-n", "2", "-e", "1", data,
         lin_file]))
    check("linvariance" in text, "the default kernel is lin")

    Xn, yn = X, y.copy()
    blank = np.random.default_rng(SEED + 3).uniform(size=IVM_N) < 0.8
    yn[blank] = 0.0
    ncnm_data = os.path.join(workdir, "ivm_ncnm.svml")
    write_svml(ncnm_data, Xn, yn)
    ncnm_file = os.path.join(workdir, "ivm_ncnm_model")
    _, out["ncnm_learn_cli_ms"] = timed(lambda: run_ivm_cli(
        ["-s", str(SEED), "learn", "-o", "ncnm", "-k", "rbf", "-a", str(IVM_D), "-#", "5",
         "-n", "3", "-e", "1", ncnm_data, ncnm_file]))
    check("type=ncnm" in open(ncnm_file).read(), "-o ncnm wrote an ncnm model")
    ll_card = cli_number(run_ivm_cli(["log-likelihood", ncnm_data, ncnm_file]),
                         "Model log likelihood:")
    ll_cpu = cli_number(run_ivm_cli(["--device", "cpu", "log-likelihood", ncnm_data,
                                     ncnm_file]), "Model log likelihood:")
    out.update(ncnm_ll=ll_card, ncnm_ll_cpu_f64=ll_cpu,
               ncnm_ll_rel=abs(ll_card - ll_cpu) / abs(ll_cpu))
    check(np.isfinite(ll_card) and out["ncnm_ll_rel"] <= IVM_CLI_TOL,
          f"ncnm log-likelihood {ll_card} vs CPU f64 {ll_cpu}")

    model = model_io.read_ivm(model_file, X=X, y=y, device=dev)
    server, out["server_factor_ms"] = timed(lambda: IvmServer(model, chunk=CHUNK))
    rng = np.random.default_rng(SEED + 4)
    requests = [rng.uniform(0.0, 1.0, (t, IVM_Q)) for t in (CHUNK, 1000, 37)]
    served, serve_ms = timed(lambda: [server.predict(r) for r in requests])
    for Xt, (mu, var) in zip(requests, served):
        want_mu, want_var = model.predict(Xt)
        check(np.isfinite(mu).all() and (var >= 0).all(), "IvmServer output")
        for what, got, want in (("mean", mu, want_mu), ("variance", var, want_var)):
            err = float(np.abs(got - want).max() / np.abs(want).max())
            check(err < 1e-4, f"IvmServer {what} vs IVM.predict: rel {err} (T={Xt.shape[0]})")
    n_pred = sum(r.shape[0] for r in requests)
    out.update(server_serve_ms=serve_ms, server_predictions_per_s=n_pred / serve_ms * 1e3)

    gp_file = os.path.join(workdir, "gp_probit_model")
    model_io.write_gp(gp_file, GP(default_kern(IVM_Q), X, y, device="cpu"))
    with open(gp_file) as f:
        probit_text = f.read().replace("type=gaussian", "type=probit")
    with open(gp_file, "w") as f:
        f.write(probit_text)
    gname = os.path.join(workdir, "gp_class")
    _, out["gp_gnuplot_cli_ms"] = timed(lambda: run_cli(["gnuplot", data, gp_file, gname]))
    grid = np.loadtxt(gname + "_prob_matrix.dat")
    check(grid.shape == (80 * 80, 3) and np.isfinite(grid).all()
          and ((grid[:, 2] >= 0) & (grid[:, 2] <= 1)).all(), "gp gnuplot's classification grid")
    check(not os.path.exists(gname + "_active_set.dat") and
          "gp_class_active_set.dat" in open(gname + "_plot.gp").read(),
          "gp gnuplot's classification script (gpc_tpu's active-set quirk)")
    log(f"phase 18 IVM CLI N={IVM_N} d={IVM_D}: {json.dumps(out)}")
    return out


def phase_ivm_kernels(dev, rng):
    """K1 (rbf) and K4 (lin) at the IVM path's shapes against their plain
    versions (rtol 1e-5, as phase 2): the selection column N × 1 (q = 2),
    the active set's d × d Gram and the serving cross-Gram d × 8192; each
    timed as 20 calls captured in one CUDA graph (graph_paired_ms)."""
    from gpc_tpu_torch.ops.gram import (dist_gram_kernel, dist_gram_plain, inner_gram_kernel,
                                        inner_gram_plain)
    X = torch.tensor(rng.standard_normal((IVM_N, IVM_Q)), dtype=torch.float32, device=dev)
    Xa, Xt = X[:IVM_D].contiguous(), torch.tensor(
        rng.standard_normal((CHUNK, IVM_Q)), dtype=torch.float32, device=dev)
    xi = X[7:8].contiguous()
    rbf = torch.tensor([1.0, 1.0], dtype=torch.float32, device=dev)
    lin = torch.tensor([1.0], dtype=torch.float32, device=dev)
    res = {}
    for name, fam, p, kern, plain, bnd in (
            ("dist_gram", "rbf", rbf, dist_gram_kernel, dist_gram_plain, k1_bound),
            ("inner_gram", "lin", lin, inner_gram_kernel, inner_gram_plain, k4_bound)):
        res[name] = {}
        for shape, (A, B) in (("column", (X, xi)), ("active", (Xa, Xa)), ("cross", (Xa, Xt))):
            got, want = kern(fam, p, A, B), plain(fam, p, A, B)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max())),
                  f"{name} at the IVM {shape} shape disagrees with its plain version ({err})")
            (ms, _, _), (plain_ms, _, _) = graph_paired_ms(
                lambda: kern(fam, p, A, B), lambda: plain(fam, p, A, B))
            bound_ms, bound_by = bnd(A.shape[0], B.shape[0], IVM_Q)
            res[name][shape] = dict(n=A.shape[0], m=B.shape[0], max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"phase 18 K1 rbf / K4 lin at the IVM shapes (q = {IVM_Q}): {json.dumps(res)}")
    return res


def k5_path_args(dev, n=N):
    """The K5 path's inputs: cmpnd(mlp, bias, white) at the defaults on the
    slice's first n rows, m = the centred targets."""
    from gpc_tpu_torch.ops.lazy_evidence import kern_block_fn
    X, y, _ = slice_data()
    X, y = X[:n], y[:n]
    kern = default_kern(Q, "mlp")
    p = torch.tensor(kern.default_params(), dtype=torch.float32, device=dev)
    Xd = torch.tensor(X, dtype=torch.float32, device=dev)
    m = torch.tensor(y - y.mean(axis=0), dtype=torch.float32, device=dev)
    return kern_block_fn(kern, p, Xd), m


def phase_k5_path(dev):
    """evidence_left_fast with the default Policy (K5 leaves) at N = 16384
    against leafinv=False (Cholesky leaves): logdet and quad within 2e-4
    relative (tests/test_lazy_evidence.py:185-187)."""
    from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_left_fast
    kfn, m = k5_path_args(dev)
    (ld, quad), ms = timed(lambda: evidence_left_fast(kfn, N, m))
    ld0, quad0 = evidence_left_fast(kfn, N, m, Policy(leafinv=False))
    rel_ld = abs(float(ld) - float(ld0)) / abs(float(ld0))
    rel_q = abs(float(quad) - float(quad0)) / abs(float(quad0))
    check(rel_ld < 2e-4 and rel_q < 2e-4,
          f"K5 leaves vs Cholesky leaves: logdet rel {rel_ld}, quad rel {rel_q}")
    log(f"phase 9 evidence_left_fast N={N} mlp, default Policy (K5 leaves): logdet "
        f"{float(ld)} quad {float(quad)} vs leafinv=False {float(ld0)} {float(quad0)} "
        f"(rel {rel_ld}, {rel_q}); first call {ms} ms")


N_RAGGED = 10000    # the slice's data cut to its first 10000 rows


def phase_k5_ragged_path(dev):
    """evidence_left_fast with the default Policy at N = 10000, cmpnd(mlp,
    bias, white) on the slice's first 10000 rows: the halving gives 64
    leaves of 156 and 157, each one ragged K5 launch; logdet and quad within
    2e-4 of leafinv=False (tests/test_lazy_evidence.py:185-187).  The
    launches of this path's first call are returned; then the path's time
    (median of 3)."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_left_fast
    kfn, m = k5_path_args(dev, N_RAGGED)
    cuda_lib.LAUNCHES.clear()
    (ld, quad), first_ms = timed(lambda: evidence_left_fast(kfn, N_RAGGED, m))
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K5 ragged-path launches: {launches}")
    check(launches.get("chol_inv_block", 0) == 64,
          f"the N={N_RAGGED} path launched chol_inv_block {launches.get('chol_inv_block', 0)} "
          f"times, not 64")
    ld0, quad0 = evidence_left_fast(kfn, N_RAGGED, m, Policy(leafinv=False))
    rel_ld = abs(float(ld) - float(ld0)) / abs(float(ld0))
    rel_q = abs(float(quad) - float(quad0)) / abs(float(quad0))
    check(rel_ld < 2e-4 and rel_q < 2e-4,
          f"ragged K5 leaves vs Cholesky leaves: logdet rel {rel_ld}, quad rel {rel_q}")
    ms = float(np.median([timed(lambda: evidence_left_fast(kfn, N_RAGGED, m))[1]
                          for _ in range(3)]))
    log(f"phase 11 evidence_left_fast N={N_RAGGED} mlp, default Policy (64 ragged K5 leaves "
        f"of 156/157): logdet {float(ld)} quad {float(quad)} vs leafinv=False {float(ld0)} "
        f"{float(quad0)} (rel {rel_ld}, {rel_q}); first call {first_ms} ms, "
        f"median of 3 {ms} ms")
    return launches, ms


def phase_chol_block_path(dev):
    """K6 as a user calls it: chol_block on the leading 1000 x 1000 block of
    the mlp Gram of the slice's data (cmpnd(mlp, bias, white) at the
    defaults), against torch.linalg.cholesky within 1e-3 of its largest
    entry.  Returns the launches of that one call."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.ops.chol_pallas import chol_block, chol_block_plain
    kfn, _ = k5_path_args(dev, 1000)
    A = kfn(0, 0, 1000, 1000).contiguous()
    cuda_lib.LAUNCHES.clear()
    L = chol_block(A)
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K6 standalone-op launches: {launches}")
    check(launches.get("chol_block", 0) == 1, "chol_block was not launched as a standalone op")
    L_p = chol_block_plain(A)
    err = float((L - L_p).abs().max())
    check(bool(torch.isfinite(L).all()) and err <= 1e-3 * float(L_p.abs().max()),
          f"K6 on the mlp Gram block: L off by {err}")
    log(f"phase 12 K6 chol_block on the mlp Gram's 1000-block: max|L - L_plain| {err}")
    return launches


# PR 16's predictions for K7 at N = 16384, D = 2 (ms; PERF.md, written before
# the first timed run): full, nodot, noleaf; nodma and nogram within 20 % of full
K7_PREDICTED_MS = {"full": (5.5, 11.0), "nodot": (4.5, 7.0), "noleaf": (3.5, 6.0)}


def phase_mega(dev, k3_ms):
    """K7 at N = 16384 on the panel phase's inputs: the probe's entry point
    once per mode (the launches are this run's), then logdet and quad
    against the plain version (the same bf16 policy, 1e-3: the leaves'
    last-bit differences flip bf16 roundings of L across 128 columns; 2e-4
    at N = 2048 in tests/test_torch_cuda.py) and the dense f32 evidence
    (gpc_tpu's panel bound, 2e-3), and two `full` calls bit for bit; ms
    per mode beside PR 16's predictions, K7 against K3 on the same inputs
    (in turns, K3, K7, K7, K3), K7's share of its bound (over 105 % fails
    the run) and its ms over the leaf chain's (nodot's ms, and the chain
    read from a traced call)."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    from gpc_tpu_torch.probes.chol_mega import (MODES, evidence_mega_rbf,
                                                evidence_mega_rbf_plain, trace_summary)
    args = panel_args(dev)
    cuda_lib.LAUNCHES.clear()
    outs = {mode: evidence_mega_rbf(*args, mode=mode) for mode in MODES}
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K7-probe launches: {launches}")
    check(launches.get("evidence_mega_rbf", 0) == len(MODES),
          "evidence_mega_rbf was not launched once per mode")
    ld, quad = (float(x) for x in outs["full"])
    again = evidence_mega_rbf(*args)
    check(all(torch.equal(a, b) for a, b in zip(outs["full"], again)),
          f"K7: two calls differ: {[float(x) for x in again]} vs {[ld, quad]}")
    ld_p, quad_p = (float(x) for x in evidence_mega_rbf_plain(*args))
    ld_d, G_d, _, _ = panel_state_rbf_plain(*args)
    ld_d, quad_d = float(ld_d), float(torch.trace(G_d))
    del G_d
    err = max(abs(ld - ld_p), abs(quad - quad_p))
    for name, a, b, tol in (("plain logdet", ld, ld_p, 1e-3), ("plain quad", quad, quad_p, 1e-3),
                            ("dense logdet", ld, ld_d, 2e-3), ("dense quad", quad, quad_d, 2e-3)):
        rel = abs(a - b) / abs(b)
        check(np.isfinite(a) and rel <= tol, f"K7 vs {name}: {a} vs {b} (rel {rel})")
    log(f"phase 13 K7 N={N}: logdet {ld} quad {quad}; plain {ld_p} {quad_p}; dense f32 {ld_d} "
        f"{quad_d} (rel {abs(ld - ld_d) / abs(ld_d)}, {abs(quad - quad_d) / abs(quad_d)}); "
        f"two calls bit for bit")
    ms_modes = {mode: cuda_ms(lambda: evidence_mega_rbf(*args, mode=mode), 3) for mode in MODES}
    predicted = dict(K7_PREDICTED_MS, nodma=(0.8 * ms_modes["full"], 1.2 * ms_modes["full"]),
                     nogram=(0.8 * ms_modes["full"], 1.2 * ms_modes["full"]))
    log("phase 13 K7 N=16384 ms per mode (PR 16's prediction beside each): " + "; ".join(
        f"{mode} {ms_modes[mode]} (predicted {predicted[mode][0]}-{predicted[mode][1]}: "
        f"{'inside' if predicted[mode][0] <= ms_modes[mode] <= predicted[mode][1] else 'outside'})"
        for mode in MODES))
    ms, plain_ms = paired_ms(lambda: evidence_mega_rbf(*args),
                             lambda: evidence_mega_rbf_plain(*args), 2)
    k7_ms, k3_pair_ms = paired_ms(lambda: evidence_mega_rbf(*args),
                                  lambda: panel_state_rbf(*args), 3)
    bound_ms, bound_by = k3_bound(N, Q, D_PANEL)
    share = bound_ms / ms
    check(share <= 1.05, f"K7: {share} of its bound (over 105 %: a timing or bound error)")
    trace = trace_summary(*args)
    log(f"phase 13 K7 N={N}: full kernel {ms} ms, plain {plain_ms} ms; K7 {k7_ms} ms against "
        f"K3 {k3_pair_ms} ms on the same inputs in turns (phase 4: {k3_ms}): "
        f"{'K7' if k7_ms < k3_pair_ms else 'K3'} is faster, K7 / K3 = {k7_ms / k3_pair_ms}; "
        f"share of the bound {share} ({bound_ms} ms, {bound_by}); over the leaf chain: "
        f"full / nodot {ms_modes['full'] / ms_modes['nodot']}; traced call {json.dumps(trace)}, "
        f"span / chain {trace['span_us'] / trace['chain_us']}")
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None, k3_ms=k3_pair_ms,
                          chain_ms=trace["chain_us"] / 1e3), \
        dict(ms=ms_modes, k3_ms=k3_pair_ms, share_of_bound=share, trace=trace)


def phase_overlap(dev):
    """K8a at the TPU probe's shapes (RC = KC = 2048, B = 512), on leaf128
    and wgmma/TMA: the probes' runs (dots with overlap_plan's K split and
    without it, independent dots, leaves, interleaved and sequential; the
    slab stream with and without the dot; each leaf part), launches
    counted.  Logged: µs a dot and TFLOP/s with the SMs the dots occupy;
    µs a leaf at B = 512 and each part's µs beside one SM's share of the
    card's bound (f32 67/132, bf16 989/132 TFLOP/s: a leaf and a part run
    on one block); inter / max(dots, leaves) and seq / (dots + leaves); µs
    a slab with and without the dot; the yardsticks torch.matmul on one
    dot's operands and on gemm512's (captured in one CUDA graph: eager
    calls that short time the host).  Then each probe against its plain
    version: 1e-5 of the largest entry for the stream without the dot
    (sums of bf16 values), 5e-5 for the stream with it (float32 sums over
    5 x 2048 products, in another order) and where float32 leaves are
    summed; the leaves also on rbf Gram blocks, with the last leaf's L and
    L⁻¹ held to 5e-5 of their largest entries.  A share of a bound over
    105 % fails the run."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.ops.chol_pallas import chol_inv_block_plain
    from gpc_tpu_torch.probes import overlap as OV
    inp = OV.probe_inputs(dev, n_bufs=64)
    s, v, al, a512, a128, hbm = (inp[k] for k in ("slab", "vrow", "aleaf", "a512", "a128", "hbm"))
    RC, KC, B = OV.RC, OV.KC, OV.B
    nd, nl = 64, 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = OV._grid()
    plans = {"dots": OV.overlap_plan(RC, KC, B, nd, 0, False, False, grid),
             "dots_unsplit": OV.overlap_plan(RC, KC, B, nd, 0, False, False, grid, ksplit=1),
             "dots_indep": OV.overlap_plan(RC, KC, B, nd, 0, False, True, grid),
             "inter": OV.overlap_plan(RC, KC, B, nd, nl, True, False, grid)}
    cuda_lib.LAUNCHES.clear()
    t = {name: cuda_ms(lambda: OV.overlap_probe(s, v, al, *args, _ksplit=ks), 3)
         for name, args, ks in (
             ("dots", (nd, 0, False), None), ("leaves", (0, nl, False), None),
             ("inter", (nd, nl, True), None), ("seq", (nd, nl, False), None),
             ("dots_indep", (nd, 0, False, True), None), ("dots_unsplit", (nd, 0, False), 1))}
    # 64 and 640 slabs: the difference of 16 and 64 read 1.99 µs a slab, 126 %
    # of the bound; a 16-slab call is shorter than its host path, so calls
    # back to back time the host (in a CUDA graph 16 -> 64 reads as 64 -> 640)
    dma = {(n, d): cuda_ms(lambda: OV.dma_probe(hbm, v, n, d), 3)
           for d in (False, True) for n in (64, 640)}
    parts = {}
    for kind, lo in (("sweep128", 8), ("fsweep128", 8), ("gemm512", 16), ("gemm128", 16),
                     ("fdiag", 2), ("ffdiag", 2)):
        ts = [cuda_ms(lambda: OV.leaf_parts_probe(kind, n, a512, a128), 2) for n in (lo, 4 * lo)]
        parts[kind] = (ts[1] - ts[0]) / (3 * lo) * 1e3
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K8a-probe launches: {launches}")
    for name in ("overlap_probe", "dma_probe", "leaf_parts_probe"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by its probe")
    flop = 2 * RC * KC * B
    slab_bytes = RC * KC * 2
    one_sm = {kind: PEAK[kind] / sms for kind in PEAK}   # FLOP/s of one SM's share
    leaf_ops = 2 * B ** 3 / 3                            # (L, L⁻¹) of B, as the bound counts it
    shares = {}
    dot_us = {k: t[k] / nd * 1e3 for k in ("dots", "dots_unsplit", "dots_indep")}
    for k, us in dot_us.items():
        shares[k] = flop / PEAK["bf16"] * 1e6 / us
    leaf_us = t["leaves"] / nl * 1e3
    shares["leaf"] = leaf_ops / one_sm["f32"] * 1e6 / leaf_us
    log(f"phase 14 K8a make_probe {nd} dots + {nl} leaves: {t} ms; per dot {dot_us['dots']} us "
        f"({flop / dot_us['dots'] / 1e6} TFLOP/s, {shares['dots']} of the bf16 bound) on "
        f"{plans['dots'].sms} SMs (K split {plans['dots'].ksplit}); unsplit "
        f"{dot_us['dots_unsplit']} us ({flop / dot_us['dots_unsplit'] / 1e6} TFLOP/s) on "
        f"{plans['dots_unsplit'].sms} SMs; independent {dot_us['dots_indep']} us "
        f"({flop / dot_us['dots_indep'] / 1e6} TFLOP/s) on {plans['dots_indep'].sms} SMs (K split "
        f"{plans['dots_indep'].ksplit}); beside the leaves {plans['inter'].sms} SMs (K split "
        f"{plans['inter'].ksplit}); per leaf {leaf_us} us ({shares['leaf']} of one SM's f32 "
        f"bound, {leaf_ops / one_sm['f32'] * 1e6} us); inter / max(dots, leaves) "
        f"{t['inter'] / max(t['dots'], t['leaves'])}, seq / (dots + leaves) "
        f"{t['seq'] / (t['dots'] + t['leaves'])}")
    for d in (False, True):
        per = (dma[(640, d)] - dma[(64, d)]) / 576 * 1e-3
        bound_s = max(slab_bytes / HBM_BPS, flop / PEAK["bf16"] if d else 0.0)
        shares[f"slab{'+dot' if d else ''}"] = bound_s / per
        log(f"phase 14 K8a slab stream {'with' if d else 'without'} the dot: {per * 1e6} us a slab, "
            f"{slab_bytes / per / 1e9} GB/s" + (f", {flop / per / 1e12} TFLOP/s" if d else "")
            + f", {bound_s / per} of its bound ({bound_s * 1e6} us)")
    part_ops = {"sweep128": ("f32", 2 * 128 ** 3 / 3), "fsweep128": ("f32", 2 * 128 ** 3 / 3),
                "gemm512": ("bf16", 2 * 512 ** 3), "gemm128": ("f32", 2 * 128 ** 3),
                "fdiag": ("f32", 2 * 512 ** 3 / 3), "ffdiag": ("f32", 2 * 512 ** 3 / 3)}
    part_bound = {k: n / one_sm[kind] * 1e6 for k, (kind, n) in part_ops.items()}
    for k, us in parts.items():
        shares[k] = part_bound[k] / us
    log(f"phase 14 K8a leaf parts, us each (differential): {parts}; one SM's bound, us: "
        f"{part_bound}; share: { {k: shares[k] for k in parts} }")
    a512b = a512.to(torch.bfloat16)
    vt = v.mT
    (lib_dots_ms, _, _), (lib_g512_ms, _, _) = graph_paired_ms(
        lambda: [torch.matmul(s[i % 2], vt) for i in range(nd)],
        lambda: torch.matmul(a512b, a512b))
    lib_dot_us, lib_g512_us = lib_dots_ms / nd * 1e3, lib_g512_ms * 1e3
    log(f"phase 14 K8a yardsticks (torch.matmul, bf16, captured in one CUDA graph, median of "
        f"the replays): {nd} calls on the dots' operands (2048, 2048) x (2048, 512)^T "
        f"{lib_dots_ms} ms, {lib_dot_us} us a dot ({flop / lib_dot_us / 1e6} TFLOP/s); "
        f"gemm512's (512, 512) x (512, 512) {lib_g512_us} us "
        f"({2 * 512 ** 3 / lib_g512_us / 1e6} TFLOP/s)")
    for k, share in shares.items():
        check(share <= 1.05, f"K8a {k}: {share} of its bound (over 105 %: a timing or bound error)")
    # each probe against its plain version; the leaves also on rbf Gram blocks,
    # whose logdet and L⁻¹ move far past the limit when a step of the factor is
    # wrong, with the last leaf's (L, L⁻¹) read back from the workspace
    gl, g512, g128 = inp["gleaf"], inp["g512"], inp["g128"]
    lw = torch.full((3, B, B), float("nan"), dtype=torch.float32, device=dev)
    L_g, M_g = chol_inv_block_plain(gl + 1e-3 * torch.eye(B, device=dev))
    worst = {}
    for name, got, want, tol in (
            ("overlap_probe", OV.overlap_probe(s, v, al, 4, 2, True),
             OV.overlap_probe_plain(s, v, al, 4, 2, True), 5e-5),
            ("overlap_probe", OV.overlap_probe(s, v, al, 4, 2, False, True),
             OV.overlap_probe_plain(s, v, al, 4, 2, False, True), 5e-5),
            ("overlap_probe", OV.overlap_probe(s, v, al, 4, 0, False, _ksplit=1),
             OV.overlap_probe_plain(s, v, al, 4, 0, False), 5e-5),
            ("overlap_probe", OV.overlap_probe(s, v, gl, 0, 2, False, _lw=lw),
             OV.overlap_probe_plain(s, v, gl, 0, 2, False), 5e-5),
            ("overlap_probe", lw[1], L_g, 5e-5), ("overlap_probe", lw[2], M_g, 5e-5),
            ("overlap_probe", OV.overlap_probe(s, v, gl, 4, 2, True),
             OV.overlap_probe_plain(s, v, gl, 4, 2, True), 5e-5),
            ("dma_probe", OV.dma_probe(hbm, v, 5, True), OV.dma_probe_plain(hbm, v, 5, True), 5e-5),
            ("dma_probe", OV.dma_probe(hbm, v, 5, False), OV.dma_probe_plain(hbm, v, 5, False), 1e-5),
            *(("leaf_parts_probe", OV.leaf_parts_probe(k, 2, a512, a128),
               OV.leaf_parts_probe_plain(k, 2, a512, a128), 5e-5) for k in OV.PARTS),
            *(("leaf_parts_probe", OV.leaf_parts_probe(k, 2, g512, g128),
               OV.leaf_parts_probe_plain(k, 2, g512, g128), 5e-5)
              for k in ("sweep128", "fsweep128", "fdiag", "ffdiag"))):
        err = float((got - want).abs().max())
        check(err <= tol * float(want.abs().max()), f"{name} vs its plain version: max abs {err}")
        worst[name] = max(worst.get(name, 0.0), err)
    log(f"phase 14 K8a vs plain, max abs err: {worst}")
    rows = {}
    p_ms = cuda_ms(lambda: OV.overlap_probe_plain(s, v, al, nd, nl, True), 1)
    rows["overlap_probe"] = (t["inter"], p_ms, bound(
        2 * (2 * RC * KC + B * KC) + 4 * (B * B + 8 * 128),
        {"bf16": flop * nd, "f32": nl * leaf_ops}))
    p_ms = cuda_ms(lambda: OV.dma_probe_plain(hbm, v, 64, False), 1)
    rows["dma_probe"] = (dma[(64, False)], p_ms, bound(64 * slab_bytes + 4 * 8 * 128, {}))
    k_ms = cuda_ms(lambda: OV.leaf_parts_probe("fdiag", 8, a512, a128), 2)
    p_ms = cuda_ms(lambda: OV.leaf_parts_probe_plain("fdiag", 8, a512, a128), 1)
    rows["leaf_parts_probe"] = (k_ms, p_ms, bound(4 * (512 * 512 + 128 * 128 + 8 * 128),
                                                  {"f32": 8 * 2 * 512 ** 3 / 3}))
    entries = {}
    for name, (k_ms, p_ms, (bound_ms, bound_by)) in rows.items():
        entries[name] = dict(max_abs_err=worst[name], ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
        log(f"phase 14 K8a {name} (kernels line: overlap {nd}+{nl} interleaved, stream of 64 "
            f"slabs without the dot, 8 fdiag): kernel {k_ms} ms, plain {p_ms} ms, "
            f"bound {bound_ms} ms ({bound_by})")
    return launches, entries, dict(overlap_ms=t, dma_ms={f"{n}{'+dot' if d else ''}": x
                                                         for (n, d), x in dma.items()},
                                   parts_us=parts, k8a_shares=shares,
                                   k8a_dot_sms={k: p.sms for k, p in plans.items()},
                                   k8a_yardsticks_us=dict(dot=lib_dot_us, gemm512=lib_g512_us,
                                                          dots_ms=lib_dots_ms))


def phase_dots(dev):
    """K8b and K8c at the TPU probes' shapes (K = 8192, B = 512, REPS =
    1024): each form (hoisted operands) and each read pattern (form c0) at
    REPS and at 64 products, launches counted; µs per product by the
    differential pair, its TFLOP/s and its share of the bound (a product's
    operations over the bf16 peak), ms at REPS and its share of the REPS
    bound; one torch.matmul (cuBLAS) of the same bf16 operands and form per
    product, the yardstick (library_ms: REPS of them); for the streamed
    patterns the L2 bytes of A a product (dot_plan's count); then each
    against its plain version at REPS, within 1e-4 of the largest entry
    (1024 sums of bf16 products near 9e4, float32 in another order).  A
    share over 105 % fails the run: some products did not run."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.probes import dotform as DF
    from gpc_tpu_torch.probes import refread as RR
    K, B, REPS = DF.K, DF.B, DF.REPS
    forms = DF.probe_inputs(dev, k=K, b=B)
    reads, Bv = RR.probe_inputs(dev, k=K, b=B)
    runs = {("dotform", f): (lambda n, f=f: DF.dotform_probe(*forms[f], f, n)) for f in DF.FORMS}
    runs.update({("refread", p): (lambda n, p=p: RR.refread_probe(reads[p], Bv, p, n))
                 for p in RR.PATTERNS})
    plains = {("dotform", f): (lambda f=f: DF.dotform_probe_plain(*forms[f], f, REPS))
              for f in DF.FORMS}
    plains.update({("refread", p): (lambda p=p: RR.refread_probe_plain(reads[p], Bv, p, REPS))
                   for p in RR.PATTERNS})
    cuda_lib.LAUNCHES.clear()
    timing = {key: DF.per_dot_us(run, 2, hi=REPS) for key, run in runs.items()}  # (µs a dot, ms)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K8b/K8c-probe launches: {launches}")
    for name in ("dotform_probe", "refread_probe"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by its probe")
    flop = 2 * K * B * B
    bound_us = flop / PEAK["bf16"] * 1e6
    l2_bytes = DF.dot_plan(K, B).streamed_bytes
    lib_us = {f: cuda_ms(lambda f=f: DF.library_dot(*forms[f], f), 20) * 1e3 for f in DF.FORMS}
    share, share_reps = {}, {}
    for (kind, which), (us, ms) in timing.items():
        form = which if kind == "dotform" else "c0"
        streamed = kind == "refread" and which != "hoisted"
        reps_ms = (k8b_bound(K, B, REPS) if kind == "dotform" else
                   k8c_bound(K, B, REPS, which))[0]
        share[f"{kind} {which}"], share_reps[f"{kind} {which}"] = bound_us / us, reps_ms / ms
        log(f"phase 15 {'K8b' if kind == 'dotform' else 'K8c'} {kind} {which} K={K} B={B}: "
            f"{us} us/dot ({flop / us / 1e6} TFLOP/s, {bound_us / us:.1%} of the {bound_us} us "
            f"bound) by the 64/{REPS} pair, {ms} ms at {REPS} ({reps_ms / ms:.1%} of "
            f"{reps_ms} ms); torch.matmul {form} {lib_us[form]} us/dot "
            f"({flop / lib_us[form] / 1e6} TFLOP/s)"
            + (f"; L2 bytes of A a product {l2_bytes}" if streamed else ""))
        check(bound_us / us <= 1.05 and reps_ms / ms <= 1.05,
              f"{kind} {which}: {bound_us / us:.1%} / {reps_ms / ms:.1%} of its bound, "
              f"over 105 %: some products did not run")
    worst, plain_ms = {}, {}
    for key, run in runs.items():
        got, want = run(REPS), plains[key]()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-4 * scale, f"{key} vs its plain version: max abs {err} (max entry {scale})")
        worst[key[0]] = max(worst.get(key[0], 0.0), err)
        log(f"phase 15 {key[0]} {key[1]} vs plain at {REPS}: max abs err {err} (max entry {scale})")
        del got, want
    for key in (("dotform", "c0"), ("refread", "read_each")):
        plain_ms[key] = cuda_ms(plains[key], 1)
    entries = {}
    rows = ((("dotform", "c0"), k8b_bound(K, B, REPS)),
            (("refread", "read_each"), k8c_bound(K, B, REPS, "read_each")))
    for key, (bound_ms, bound_by) in rows:
        entries[f"{key[0]}_probe"] = dict(
            max_abs_err=worst[key[0]], ms=timing[key][1], plain_ms=plain_ms[key],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_us["c0"] * REPS * 1e-3)
        log(f"phase 15 {key[0]}_probe (kernels line: {key[1]} at {REPS}): kernel {timing[key][1]} "
            f"ms, plain {plain_ms[key]} ms, {REPS} x torch.matmul {lib_us['c0'] * REPS * 1e-3} ms, "
            f"bound {bound_ms} ms ({bound_by})")
    return launches, entries, dict(
        us_per_dot={f"{k} {w}": us for (k, w), (us, _) in timing.items()},
        ms_at_reps={f"{k} {w}": ms for (k, w), (_, ms) in timing.items()},
        share_of_bound=share, share_of_bound_at_reps=share_reps,
        l2_bytes_a_product_streamed=l2_bytes, torch_matmul_us_per_dot=lib_us)


def phase_vpu(dev):
    """K8d at the TPU probe's shapes (B = 512; REPS = 2048, and 1024
    iterations for the matvec and the store, in both modes): each kernel at
    its full count and an eighth of it, 10 calls captured in a CUDA graph
    (the store and the Gram tile are shorter than their host path), launches
    counted; µs per iteration by the differential pair; the full count also
    eager (3 calls back to back, as phase 16 timed it before); the store's
    split among warps and its TB/s written; the matvec's cluster size and where its A
    lives, its µs a step at each cluster size, and as a reference line (not
    the bound) the plain chain captured in one CUDA graph; then each against
    its plain version: exp and the Gram tile within 1e-5 of the largest
    entry, the matvec chain within 1e-4 (float32 in another order over the
    chain), the store's written slots and o bit for bit."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.probes import vpu as VP
    B, REPS = VP.B, VP.REPS
    inp = VP.probe_inputs(dev, b=B)
    A, X, n2, v = inp["A"], inp["X"], inp["n2"], inp["v"]
    runs = VP.runs(inp)
    cuda_lib.LAUNCHES.clear()
    timing, eager = {}, {}
    for name, (fn, n) in runs.items():
        t_lo, t_hi = (graph_ms(lambda m=m: fn(m), calls=10) for m in (n // 8, n))
        timing[name] = ((t_hi - t_lo) / (n - n // 8) * 1e3, t_hi)
        eager[name] = cuda_ms(lambda: fn(n), 3)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"K8d-probe launches: {launches}")
    for name in ("vpu_exp", "vpu_gram_tile", "vpu_matvec", "vpu_stage_store"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by its probe")
    cs = VP.matvec_cluster(B)
    where = VP.matvec_home(B, cs)
    mv_us = {c: (cuda_ms(lambda c=c: VP.vpu_matvec(A, v, REPS // 2, _cluster=c), 3)
                 - cuda_ms(lambda c=c: VP.vpu_matvec(A, v, REPS // 16, _cluster=c), 3))
             / (REPS // 2 - REPS // 16) * 1e3 for c in sorted({8, cs})}
    plain_graph_us = graph_ms(lambda: VP.vpu_matvec_plain(A, v, REPS // 2), calls=1) \
        / (REPS // 2) * 1e3
    log(f"phase 16 K8d matvec B={B}: one cluster of {cs} blocks (the largest this card "
        f"runs), A's {B // cs} columns a block in {where}; {timing['matvec'][0]} us a step "
        f"(differential), by cluster size {mv_us}; reference, not the bound: the plain chain "
        f"captured in one CUDA graph {plain_graph_us} us a step")
    written = REPS // 2 * B * B * 2
    plan = VP.store_plan(B, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"phase 16 K8d store plan B={B}: {plan.chunks} chunks of 8 KiB x {plan.classes} "
        f"iteration classes, {plan.blocks} blocks of {VP.STORE_WARPS} warps")
    for name, (us, ms) in timing.items():
        extra = (f"; {written} bytes written through L2 (outside the byte bound), "
                 f"{written / (ms * 1e-3) / 1e12} TB/s written, "
                 f"{B * B * 2 / us / 1e6} TB/s by the differential"
                 if name.startswith("store") else "")
        log(f"phase 16 K8d {name} B={B}: {us} us/iter (differential), {ms} ms at "
            f"{runs[name][1]} (10 calls in a CUDA graph; eager, 3 calls back to back: "
            f"{eager[name]} ms){extra}")
    plains = {"exp": lambda: VP.vpu_exp_plain(A, REPS),
              "gram": lambda: VP.vpu_gram_tile_plain(X, n2, REPS),
              "matvec": lambda: VP.vpu_matvec_plain(A, v, REPS // 2),
              "store-bulk": lambda: VP.vpu_stage_store_plain(A, REPS // 2)}
    errs = {}
    for name, tol in (("exp", 1e-5), ("gram", 1e-5), ("matvec", 1e-4)):
        got, want = runs[name][0](runs[name][1]), plains[name]()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol * scale,
              f"K8d {name} vs its plain version: max abs {err} (max entry {scale})")
        errs[name] = err
    big_p, o_p = plains["store-bulk"]()
    w = VP.written_slots(REPS // 2)
    for mode in VP.MODES:
        big, o = VP.vpu_stage_store(A, REPS // 2, mode)
        check(torch.equal(big[:w], big_p[:w]) and torch.equal(o, o_p),
              f"K8d store ({mode}) differs from its plain version")
    errs["store"] = 0.0
    log(f"phase 16 K8d vs plain, max abs err: {errs} (the store's {w} slots and o bit for bit, "
        f"both modes)")
    sfu = sfu_peak()
    rows = {"vpu_exp": ("exp", k8d_exp_bound(B, REPS, sfu)),
            "vpu_gram_tile": ("gram", k8d_gram_bound(B, REPS, sfu)),
            "vpu_matvec": ("matvec", k8d_matvec_bound(B, REPS // 2)),
            "vpu_stage_store": ("store-bulk", k8d_store_bound(B))}
    entries = {}
    for entry, (name, (bound_ms, bound_by)) in rows.items():
        p_ms = cuda_ms(plains[name], 1)
        entries[entry] = dict(max_abs_err=errs[name.split("-")[0]], ms=timing[name][1],
                              plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, ms_eager=eager[name])
        if entry == "vpu_matvec":
            entries[entry].update(cluster=cs, plain_graph_us_a_step=plain_graph_us)
        log(f"phase 16 K8d {entry} ({name} at {runs[name][1]}): kernel {timing[name][1]} ms, "
            f"plain {p_ms} ms, bound {bound_ms} ms ({bound_by}; SFU {sfu / 1e12} T exp/s)")
    return launches, entries, dict(us_per_iter={k: us for k, (us, _) in timing.items()},
                                   ms_at_full={k: ms for k, (_, ms) in timing.items()},
                                   ms_at_full_eager=eager, store_plan=plan._asdict(),
                                   matvec_cluster=cs, matvec_us_by_cluster=mv_us,
                                   matvec_plain_graph_us=plain_graph_us)


def phase_zoo_timing(dev):
    """N = 16384, cmpnd(mlp, bias, white): forward and backward ms of the
    objective under dense and lazy (median of 3), the peak device memory
    above the data, θ̄ lazy vs dense (1e-3 relative L2, both f32), and the
    forward evidence alone: GP.log_likelihood under lazy (which needs no
    gradient, so it takes K5 leaves) and evidence_left_fast on the K5 path."""
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.ops.evidence_fast import evidence_left_fast
    X, y, _ = slice_data()
    out, grads = {}, {}
    for engine in ("dense", "lazy"):
        model = GP(default_kern(Q, "mlp"), X, y, device=dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs = [with_evidence(engine, lambda: value_and_grad_split(model)) for _ in range(3)]
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        f, grads[engine] = runs[0][0], runs[0][1]
        check(np.isfinite(f) and np.isfinite(grads[engine]).all(), f"mlp {engine} value_and_grad")
        fwd = float(np.median([r[2] for r in runs]))
        bwd = float(np.median([r[3] for r in runs]))
        out[engine] = dict(forward_ms=fwd, backward_ms=bwd, peak_gib=peak_gib, nlml=f)
        log(f"phase 10 mlp value_and_grad N={N} {engine} (median of 3): forward {fwd} ms, "
            f"backward {bwd} ms; nlml {f}; peak memory above the data {peak_gib} GiB")
        del model
        torch.cuda.empty_cache()
    rel = rel_l2(grads["lazy"], grads["dense"])
    check(rel < 1e-3, f"mlp θ̄ lazy vs dense at N={N}: rel L2 {rel}")
    log(f"phase 10 mlp gradient N={N}: lazy θ̄ {grads['lazy'].tolist()} vs dense "
        f"{grads['dense'].tolist()} (rel L2 {rel})")
    model = GP(default_kern(Q, "mlp"), X, y, device=dev)
    fwd_lazy = [with_evidence("lazy", lambda: timed(model.log_likelihood)[1]) for _ in range(3)]
    kfn, m = k5_path_args(dev)
    fwd_k5 = [timed(lambda: evidence_left_fast(kfn, N, m))[1] for _ in range(3)]
    out["lazy_evidence_ms"] = float(np.median(fwd_lazy))
    out["k5_path_ms"] = float(np.median(fwd_k5))
    log(f"phase 10 evidence N={N} mlp (median of 3): lazy GP.log_likelihood "
        f"{out['lazy_evidence_ms']} ms; evidence_left_fast with K5 leaves {out['k5_path_ms']} ms")
    return out


# ---------------------------------------------------------------------------
# phases 19 and 20: the GP-LVM / GPDM and the matrix-free iterative engine
# ---------------------------------------------------------------------------

GPLVM_N, GPLVM_D, GPLVM_Q = 16384, 4, 2     # gpc_tpu's GP-LVM record (bench.py:309-351)
GPLVM_SMALL = 4096                          # the -c rbf, -I rand and GPDM runs
GPLVM_CPU_ROWS = 2048                       # the CPU float64 route's cut
PANEL_SPREAD = 4.0    # latents ×4: inside K3's bf16 domain (κ·ε_bf16 < 1 there)
BREAKS = (0, 5000, 12000)


def gplvm_data(n=GPLVM_N):
    """bench.py's GP-LVM data: Y = tanh(Z·W) + 0.1ε with Z ~ N(0, 1)^(N×2),
    W ~ N(0, 1)^(2×4) from default_rng(0), as float32 values; and the sign
    of Z's first column as 0/1 labels (for gnuplot's scatter)."""
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((GPLVM_N, GPLVM_Q))
    W = rng.standard_normal((GPLVM_Q, GPLVM_D))
    Y = (np.tanh(Z @ W) + 0.1 * rng.standard_normal((GPLVM_N, GPLVM_D))).astype(np.float32)
    return Y[:n].astype(np.float64), (Z[:n, :1] > 0).astype(np.float64)


def gplvm_model(Y, dev, **kw):
    """cmpnd(rbf, bias, white) at its defaults, PCA init, latents
    regularised: bench.py's GP-LVM."""
    from gpc_tpu_torch.models.gplvm import GPLVM
    return GPLVM(default_kern(GPLVM_Q), Y, latent_dim=GPLVM_Q, device=dev, **kw)


def gplvm_vag_split(model, theta=None):
    """(nlml, θ̄, forward ms, backward ms) of one GP-LVM evaluation."""
    from gpc_tpu_torch import as_tensor
    nlml = model.objective()
    th = as_tensor(model.theta if theta is None else theta, model.device).requires_grad_(True)
    f, fwd_ms = timed(lambda: nlml(th))
    (g,), bwd_ms = timed(lambda: torch.autograd.grad(f, th))
    return float(f.detach()), g.cpu().numpy().astype(np.float64), fwd_ms, bwd_ms


def gplvm_f64_nlml(model, theta=None):
    """The bench model's objective (no dynamics, priors or learned scales;
    latents regularised) in float64 on the card, dense."""
    dev = model.device
    th = torch.as_tensor(model.theta if theta is None else theta, dtype=torch.float64, device=dev)
    kp, _, Xv, _ = model.spec.unpack(th)
    m = torch.as_tensor((model.y - model.noise_bias) / model.fixed_scales, dtype=torch.float64,
                        device=dev)
    ld, quad, _, L = gplvm_terms_f64(kp, Xv, m)
    del L
    return 0.5 * (quad + model.spec.data_dim * ld + float(torch.sum(Xv * Xv)))


def gplvm_terms_f64(p, X, m, mask=None):
    """(logdet, quad, α, L) of cmpnd(rbf, bias, white) at p over X —
    knocked out to the identity where mask is 0 — in float64 on the card,
    the Gram from the plain map (K1 takes float32 only)."""
    from gpc_tpu_torch.ops.gram import dist_gram_plain
    p64, X64, m64 = (t.double() for t in (p, X, m))
    K = dist_gram_plain("rbf", p64[:2], X64, X64) + p64[2]
    if mask is not None:
        k = mask.double()
        K = K * k[:, None] * k[None, :]
        K.diagonal().add_(1.0 - k)
        K.diagonal().add_(p64[3] * k)
    else:
        K.diagonal().add_(p64[3])
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(m64, L)
    ld = float(2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return ld, float(torch.sum(m64 * alpha)), alpha, L


@contextlib.contextmanager
def evidence_env(engine, **iter_knobs):
    """GPC_TPU_EVIDENCE (and GPC_TPU_ITER_* knobs) for a block, restored after."""
    keys = {"GPC_TPU_EVIDENCE": engine,
            **{f"GPC_TPU_ITER_{k.upper()}": str(v) for k, v in iter_knobs.items()}}
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_gplvm_cli(argv, engine="dense"):
    """The port's gplvm CLI in-process under `engine`; its standard output."""
    from gpc_tpu_torch.cli import gplvm as gplvm_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out), evidence_env(engine):
        gplvm_cli.main(argv)
    return out.getvalue()


def same_numbers(a, b, rtol=1e-12):
    """The same text around the numbers, the numbers within rtol."""
    num = r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?"
    if re.sub(num, "#", a) != re.sub(num, "#", b):
        return False
    return np.allclose([float(v) for v in re.findall(num, a)],
                       [float(v) for v in re.findall(num, b)], rtol=rtol, atol=0.0)


def phase_gplvm(dev):
    """19a: at N = 16384, D = 4, q = 2, the objective alone and
    value_and_grad (forward and backward ms, median of 3, peak GiB) under
    dense, lazy and panel, beside the dense float64 objective.  Held: the
    card against the port's CPU float64 route on the first 2048 rows
    (objective 1e-4, θ̄ 1e-3 relative L2; dense and lazy); lazy against
    dense at N = 16384 (1e-4, 1e-3).  Panel's bf16 factor fails on the
    GP-LVM's own latents (phase_gplvm_kernels holds K3 to the plain route
    of its bf16 policy there); with the latents ×4, inside its domain, the
    panel objective is held to gpc_tpu's panel bound 2e-3 of float64 and
    θ̄ to 8e-2 of dense.  19b: 10 SCG iterations under lazy, ms per
    iteration, the objective never rising."""
    Y, _ = gplvm_data()
    model = gplvm_model(Y, dev)
    out, grads, vals = {}, {}, {}
    f64 = gplvm_f64_nlml(model)
    for engine in ("dense", "lazy", "panel"):
        with evidence_env(engine):
            obj, obj_ms = timed(lambda: -model.log_likelihood())
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            runs = [gplvm_vag_split(model) for _ in range(3)]
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        vals[engine], grads[engine] = runs[0][0], runs[0][1]
        fwd = float(np.median([r[2] for r in runs]))
        bwd = float(np.median([r[3] for r in runs]))
        gap = abs(vals[engine] - f64) / abs(f64)
        out[engine] = dict(objective_ms=obj_ms, forward_ms=fwd, backward_ms=bwd, peak_gib=peak_gib,
                           nlml=vals[engine], objective_alone=obj, rel_to_f64=gap)
        log(f"phase 19 GP-LVM N={GPLVM_N} D={GPLVM_D} q={GPLVM_Q} {engine}: objective alone "
            f"{obj} ({obj_ms} ms); value_and_grad (median of 3) forward {fwd} ms, backward {bwd} "
            f"ms, nlml {vals[engine]}, peak above the data {peak_gib} GiB; dense float64 {f64} "
            f"(rel {gap})")
        torch.cuda.empty_cache()
    for engine in ("dense", "lazy"):
        check(np.isfinite(vals[engine]) and np.isfinite(grads[engine]).all(),
              f"GP-LVM {engine} value_and_grad not finite")
    rel_v = abs(vals["lazy"] - vals["dense"]) / abs(vals["dense"])
    rel_g = rel_l2(grads["lazy"], grads["dense"])
    check(rel_v < 1e-4 and rel_g < 1e-3, f"GP-LVM lazy vs dense at N={GPLVM_N}: value rel "
                                         f"{rel_v}, θ̄ rel L2 {rel_g}")
    log(f"phase 19 GP-LVM lazy vs dense at N={GPLVM_N}: value rel {rel_v}, θ̄ rel L2 {rel_g}")

    # the card against the CPU float64 route on the first rows
    Yc = Y[:GPLVM_CPU_ROWS]
    cpu = gplvm_model(Yc, "cpu")
    for engine in ("dense", "lazy"):
        with evidence_env(engine):
            f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
            card = gplvm_model(Yc, dev)
            f, g = card.value_and_grad_fn()(card.theta)
        rv, rg = abs(f - f_ref) / abs(f_ref), rel_l2(g, g_ref)
        check(rv < 1e-4 and rg < 1e-3, f"GP-LVM {engine} on the card vs CPU f64 at "
                                       f"N={GPLVM_CPU_ROWS}: value rel {rv}, θ̄ rel L2 {rg}")
        log(f"phase 19 GP-LVM N={GPLVM_CPU_ROWS} {engine}: card {f} vs CPU f64 {f_ref} "
            f"(rel {rv}), θ̄ rel L2 {rg}")

    theta_s = model.theta.copy()
    theta_s[model.spec.kern.n_params:] *= PANEL_SPREAD
    f64_s = gplvm_f64_nlml(model, theta_s)
    sg = {}
    for engine in ("dense", "panel"):
        with evidence_env(engine):
            runs = [gplvm_vag_split(model, theta_s) for _ in range(3)]
        sg[engine] = runs[0][:2]
        out[f"{engine}_spread"] = dict(forward_ms=float(np.median([r[2] for r in runs])),
                                       backward_ms=float(np.median([r[3] for r in runs])),
                                       nlml=runs[0][0])
        torch.cuda.empty_cache()
    gap = abs(sg["panel"][0] - f64_s) / abs(f64_s)
    rel_p = rel_l2(sg["panel"][1], sg["dense"][1])
    check(gap <= 2e-3 and rel_p < 8e-2, f"panel GP-LVM at latents x{PANEL_SPREAD}: objective "
                                         f"rel {gap} to float64, θ̄ rel L2 {rel_p} to dense")
    log(f"phase 19 panel GP-LVM value_and_grad at latents x{PANEL_SPREAD}: nlml {sg['panel'][0]} "
        f"vs float64 {f64_s} (rel {gap}), dense f32 {sg['dense'][0]}; θ̄ vs dense rel L2 "
        f"{rel_p}; ms {out['panel_spread']}")

    # 19b: SCG under lazy
    objs, marks = [], []

    def on_checkpoint(it, st):
        marks.append(time.perf_counter())
        objs.append(float(st["old_obj"]))

    from gpc_tpu_torch.optim import scg_checkpointed
    with evidence_env("lazy"):
        vag = model.value_and_grad_fn()
        marks.append(time.perf_counter())
        res = scg_checkpointed(vag, model.theta, max_iters=10, ckpt_every=1,
                               on_checkpoint=on_checkpoint)
    per_iter = np.diff(marks).tolist()
    check(res.iters == 10 and all(b <= a for a, b in zip([vals["lazy"]] + objs, objs)),
          f"GP-LVM lazy SCG: the objective rose or stopped early: {objs}")
    out["scg_lazy"] = dict(objective=[vals["lazy"]] + objs, ms_per_iteration=float(
        np.median(per_iter) * 1e3), iterations=res.iters)
    log(f"phase 19 GP-LVM SCG under lazy, 10 iterations: objective {vals['lazy']} -> {objs}; "
        f"ms per iteration {[t * 1e3 for t in per_iter]}")
    return out


def phase_gplvm_cli(dev, workdir):
    """19c: gplvm learn -# 10 under lazy on the 16384-row SVM-light file,
    display and gnuplot (80 × 80); the learned file read back gives
    log-likelihood = −(final objective) within 1e-4.  Then -c rbf (bK from
    K1 over Y), -I rand and -k mlp (K4) at N = 4096.  19d: GPDM, -D rbf at N = 4096
    under dense, and the learned model's objective under iterative (the
    masked engine for dynK) within gpc_tpu's 0.1 (tests/test_iterative.py:331)."""
    from gpc_tpu_torch.io import model_io
    from gpc_tpu_torch.io.svml import write_svml
    out = {}
    Y, labels = gplvm_data()
    data = os.path.join(workdir, "gplvm.svml")
    write_svml(data, Y, labels)
    model_file = os.path.join(workdir, "gplvm_model")
    text, ms = timed(lambda: run_gplvm_cli(["-s", "1", "learn", "-#", "10", data, model_file],
                                           "lazy"))
    final, iters = learned(text)
    check(iters == 10 and np.isfinite(final), f"gplvm learn: {iters} iterations, {final}")
    shown = run_gplvm_cli(["display", model_file])
    check(same_numbers(shown.strip(), "\n".join(text.splitlines()[:len(shown.splitlines())])),
          "gplvm display disagrees with learn's summary")
    with evidence_env("lazy"):
        back, lab = model_io.read_gplvm(model_file, device=dev)
        ll = back.log_likelihood()
    rel = abs(ll + final) / abs(final)
    check(rel <= 1e-4 and lab is not None and len(lab) == GPLVM_N,
          f"read-back log-likelihood {ll} vs -{final}: rel {rel}")
    name = os.path.join(workdir, "gp16k")
    _, gn_ms = timed(lambda: run_gplvm_cli(["gnuplot", model_file, name]))
    grid = np.loadtxt(f"{name}_variance_matrix.dat")
    check(grid.shape == (80 * 80, 3) and np.isfinite(grid).all(), "gplvm gnuplot grid")
    check(os.path.exists(f"{name}_latent_data0.dat") and os.path.exists(f"{name}_plot.gp"),
          "gplvm gnuplot files")
    out["learn16k"] = dict(cli_ms=ms, final=final, read_back=ll, gnuplot_ms=gn_ms)
    log(f"phase 19 gplvm CLI N={GPLVM_N} under lazy: learn -# 10 objective -> {final} ({ms} ms "
        f"CLI wall); read back log-likelihood {ll} (rel {rel}); gnuplot 80x80 {gn_ms} ms")

    Ys, ls = gplvm_data(GPLVM_SMALL)
    small = os.path.join(workdir, "gplvm4k.svml")
    write_svml(small, Ys, ls)
    for tag, flags in (("back_rbf", ["-c", "rbf"]), ("rand", ["-I", "rand"]),
                       ("mlp", ["-k", "mlp"]), ("gpdm", ["-D", "rbf"])):
        path = os.path.join(workdir, f"m_{tag}")
        text, ms = timed(lambda: run_gplvm_cli(["-s", "3", "learn", "-#", "5"] + flags
                                               + [small, path], "dense"))
        final, iters = learned(text)
        with evidence_env("dense"):
            back, _ = model_io.read_gplvm(path, device=dev)
            ll = back.log_likelihood()
        rel = abs(ll + final) / abs(final)
        check(iters == 5 and rel <= 1e-4, f"gplvm learn {flags} N={GPLVM_SMALL}: objective "
                                          f"{final}, read back {ll} (rel {rel})")
        out[tag] = dict(cli_ms=ms, final=final, read_back=ll)
        log(f"phase 19 gplvm CLI N={GPLVM_SMALL} {' '.join(flags)}: learn -# 5 objective -> "
            f"{final} ({ms} ms CLI wall), read back {ll} (rel {rel})")
    # 19d: the GPDM's objective under iterative (latent and masked dynamics
    # engines) against dense
    with evidence_env("dense"):
        f_d, g_d, _, _ = gplvm_vag_split(back)
    with evidence_env("iterative"):
        (f_i, g_i, fwd, bwd) = gplvm_vag_split(back)
    rel = abs(f_i - f_d) / abs(f_d)
    check(np.isfinite(g_i).all() and rel < 0.1, f"GPDM iterative vs dense: rel {rel}")
    out["gpdm_iterative"] = dict(dense=f_d, iterative=f_i, rel=rel, forward_ms=fwd,
                                 backward_ms=bwd)
    log(f"phase 19 GPDM N={GPLVM_SMALL} -D rbf: objective dense {f_d}, iterative {f_i} (rel "
        f"{rel}); iterative value_and_grad forward {fwd} ms, backward {bwd} ms")
    return out


def iterative_check(tag, kern, p, X, m, mask=None, evidence=None, phase=20):  # noqa: C901
    """One iterative evidence at full size against float64: quad within
    the bound its CG residual gives (|mᵀK⁻¹r| ≤ Σⱼ‖αⱼ‖‖rⱼ‖, with r the
    true residual of the CG iterate, plus float32 rounding of the sum) and
    logdet within 0.05 relative (tests/test_iterative.py:120).  Returns the
    record: values, the achieved relative residual, CG iterations, ms and
    K1 launches.  `evidence` () → (logdet, quad) replaces the
    single-process engine (the distributed one of phase 23)."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.ops import iterative as TI
    before = cuda_lib.LAUNCHES["dist_gram"]
    with torch.no_grad():
        if evidence is not None:
            (ld, quad), ms = timed(evidence)
        elif mask is None:
            (ld, quad), ms = timed(lambda: TI.kern_evidence_iterative(kern, p, X, m))
        else:
            (ld, quad), ms = timed(lambda: TI.kern_evidence_iterative_masked(kern, p, X, m, mask))
    launches = cuda_lib.LAUNCHES["dist_gram"] - before
    sol = TI.LAST_SOLVE
    D = m.shape[1]
    ld, quad = float(ld), float(quad)
    ld64, q64, alpha, L = gplvm_terms_f64(p, X, m, mask)
    x = sol.x[:, :D].double()
    K_x = L @ (L.T @ x)
    r = m.double() - K_x
    del L, K_x
    bound_q = float(torch.sum(torch.linalg.vector_norm(alpha, dim=0)
                              * torch.linalg.vector_norm(r, dim=0)))
    slack = 1e-5 * abs(q64)
    rel_res = float(torch.max(torch.linalg.vector_norm(r, dim=0)
                              / torch.linalg.vector_norm(m.double(), dim=0)))
    rel_ld = abs(ld - ld64) / abs(ld64)
    check(abs(quad - q64) <= bound_q + slack and rel_ld < 0.05,
          f"iterative {tag}: quad {quad} vs {q64} (bound {bound_q} + {slack}), logdet {ld} vs "
          f"{ld64} (rel {rel_ld})")
    rec = dict(logdet=ld, quad=quad, logdet_f64=ld64, quad_f64=q64, rel_logdet=rel_ld,
               quad_err=abs(quad - q64), quad_bound=bound_q, rel_residual=rel_res,
               cg_iters=int(sol.iters), ms=ms, k1_launches=launches)
    log(f"phase {phase} iterative {tag}: {json.dumps(rec)}")
    return rec


def phase_iterative(dev):
    """20: the matrix-free engine at N = 16384 (row blocks 2048 × 16384,
    the defaults: 16 SLQ probes of 32 Lanczos steps, 16 trace probes, 256
    CG iterations, which float32 runs to the end): the FTC evidence
    (cmpnd(rbf, bias, white), the slice's q = 8 data) and the GP-LVM's
    (q = 2 PCA latents), each against float64 (iterative_check) with its
    value_and_grad timed (the GP-LVM's with its peak memory); then the
    masked form (the GP-LVM's dynamics Gram with breaks at 0, 5000, 12000)."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.models.gplvm import _break_mask, _xout
    out = {}
    X, y, _ = slice_data()
    gp = GP(default_kern(Q), X, y, device=dev)
    theta, Xd, yd, bias, scales = gp._args()
    _, kp, _, _ = gp.spec.unpack(theta)
    out["ftc"] = iterative_check("FTC N=16384 q=8", gp.spec.kern, kp, Xd, (yd - bias) / scales)
    with evidence_env("iterative"):
        f, g, fwd, bwd = value_and_grad_split(gp)
    check(np.isfinite(f) and np.isfinite(g).all(), "FTC iterative value_and_grad")
    out["ftc"].update(vag_forward_ms=fwd, vag_backward_ms=bwd, nlml=f)
    del gp
    torch.cuda.empty_cache()

    Y, _ = gplvm_data()
    model = gplvm_model(Y, dev)
    kp, _, Xv, _ = model.spec.unpack(as_tensor(model.theta, dev))
    m = as_tensor((Y - model.noise_bias) / model.fixed_scales, dev)
    out["gplvm"] = iterative_check("GP-LVM N=16384 q=2", model.spec.kern, kp, Xv, m)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with evidence_env("iterative"):
        f, g, fwd, bwd = gplvm_vag_split(model)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(np.isfinite(f) and np.isfinite(g).all(), "GP-LVM iterative value_and_grad")
    out["gplvm"].update(vag_forward_ms=fwd, vag_backward_ms=bwd, nlml=f, peak_gib=peak_gib)
    spec = dataclasses.replace(model.spec, dyn_kern=default_kern(GPLVM_Q), dyn_breaks=BREAKS)
    out["masked"] = iterative_check(f"masked, breaks {BREAKS}", spec.dyn_kern, kp, Xv,
                                    _xout(spec, Xv), _break_mask(spec, Xv))
    log(f"phase 20 value_and_grad under iterative: FTC forward {out['ftc']['vag_forward_ms']} "
        f"ms, backward {out['ftc']['vag_backward_ms']} ms; GP-LVM forward {fwd} ms, backward "
        f"{bwd} ms, peak above the data {peak_gib} GiB")
    return out


def phase_gplvm_kernels(dev, rng):
    """K1 rbf at the GP-LVM's shapes (q = 2): the 16384² Gram and the
    iterative engine's 2048 × 16384 row block, against the plain version
    (rtol 1e-5) and timed in turns.  K3 on the GP-LVM's evidence (the
    bias-split right-hand side [m | 1] over the PCA latents, and over the
    latents ×4) against the plain route of its bf16 policy
    (probes/chol_mega's): the two must agree in whether the bf16 factor
    holds, and where it holds within 1e-3 (K7's bound against the same
    route); the gap to float64 printed."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf
    from gpc_tpu_torch.ops.gram import dist_gram, dist_gram_plain
    from gpc_tpu_torch.probes.chol_mega import evidence_mega_rbf_plain
    Y, _ = gplvm_data()
    model = gplvm_model(Y, dev)
    # panel: K3 against the plain route of its bf16 policy, on the GP-LVM's
    # latents and on the latents ×4
    kp, _, Xv, _ = model.spec.unpack(as_tensor(model.theta, dev))
    m = as_tensor((Y - model.noise_bias) / model.fixed_scales, dev)
    rhs = torch.cat([m, torch.ones((GPLVM_N, 1), device=dev)], dim=1).contiguous()
    kp0 = kp * torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)   # K₀: the bias split off
    panel = {}
    for spread in (1.0, PANEL_SPREAD):
        X = (Xv * spread).contiguous()
        args = (X, rhs, float(kp[0]), float(kp[1]), float(kp[3]))
        ld3, G3, _, _ = panel_state_rbf(*args)
        ld3, q3 = float(ld3), float(torch.trace(G3))
        ldp, qp = (float(v) for v in evidence_mega_rbf_plain(*args))
        ld64, q64, _, L = gplvm_terms_f64(kp0, X, rhs)
        del L
        fin3, finp = np.isfinite([ld3, q3]).all(), np.isfinite([ldp, qp]).all()
        panel[spread] = dict(k3=[ld3, q3], bf16_plain=[ldp, qp], f64=[ld64, q64])
        log(f"phase 19 panel GP-LVM evidence (logdet₀, quad of [m | 1]), latents x{spread}: K3 "
            f"{ld3} {q3}; plain route of the bf16 policy {ldp} {qp}; float64 {ld64} {q64} (gap "
            f"to float64 {abs(ld3 - ld64) / abs(ld64)}, {abs(q3 - q64) / abs(q64)})")
        check(fin3 == finp, f"K3 and the plain bf16 route disagree on whether the factor holds "
                            f"at latents x{spread}: {ld3} {q3} vs {ldp} {qp}")
        if fin3:
            err = max(abs(ld3 - ldp) / abs(ldp), abs(q3 - qp) / abs(qp))
            check(err <= 1e-3, f"K3 vs the plain bf16 route at latents x{spread}: rel {err}")
        torch.cuda.empty_cache()
    check(np.isfinite(panel[PANEL_SPREAD]["k3"]).all(),
          f"K3 not finite inside its domain (latents x{PANEL_SPREAD})")

    p = torch.tensor([1.0, 1.0], device=dev)
    res = {}
    for n, mm in ((GPLVM_N, GPLVM_N), (2048, GPLVM_N)):
        A = torch.tensor(rng.standard_normal((n, GPLVM_Q)), dtype=torch.float32, device=dev)
        B = A if n == mm else torch.tensor(rng.standard_normal((mm, GPLVM_Q)),
                                           dtype=torch.float32, device=dev)
        got, want = dist_gram("rbf", p, A, B), dist_gram_plain("rbf", p, A, B)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"K1 at {n}x{mm} q=2: {err}")
        del got, want
        ms, plain_ms = paired_ms(lambda: dist_gram("rbf", p, A, B),
                                 lambda: dist_gram_plain("rbf", p, A, B), 10)
        bound_ms, bound_by = k1_bound(n, mm, GPLVM_Q)
        res[f"{n}x{mm}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by)
        torch.cuda.empty_cache()
    log(f"phase 19 K1 rbf at the GP-LVM shapes (q = 2): {json.dumps(res)}")
    return res, {str(k): v for k, v in panel.items()}


# ---------------------------------------------------------------------------
# phases 21 and 22: the host and interop surface; the distributed layer
# ---------------------------------------------------------------------------

INTEROP_TOL = 1e-6    # -f 1 vs -f 0, and .mat round trips, relative
SERVE_TOL = 1e-4      # fgp's query vs GP.predict (PERF.md §2's serving limits)
DIST_FTC_TOL = (1e-4, 1e-3)                  # FTC value, θ̄ relative L2 (PERF.md §2)
DIST_SPARSE_TOL = (SPARSE_TOL, SPARSE_GRAD_TOL)   # phase 17's limits at β = 1
DIST_SCG_TOL = (1e-5, 1e-4)                  # SCG's final objective, θ relative L2
SCG_ROWS, SCG_M = 2048, 128                  # phase 17's gradient cut, where SCG moves
# where SCG moves, its finite-difference curvature probe amplifies the
# float32 gradients' last-bit differences (dist vs single: 1e-9–1e-7 relative
# L2): on an H100 80GB HBM3 at 700 W this cut read 1.0e-3 on the objective
# and 6.6e-4 on θ after 3 iterations, and this limit was set after that
# reading (PERF.md §6); the float64 CPU tests hold 5 iterations to 1e-10
# (tests/test_torch_parallel.py).
DIST_SCG_MOVING_TOL = (1e-2, 1e-2)
WAIT_S = 600.0        # the bound on every wait for a process this phase starts


def repo_env(**extra):
    """The environment for a child process of this checkout."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def run_proc(argv, cwd, env=None, timeout=WAIT_S):
    """A child process run to its end: (returncode, stdout, stderr, wall ms)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable] + argv, cwd=cwd, env=env or repo_env(),
                         capture_output=True, text=True, timeout=timeout)
    return res.returncode, res.stdout, res.stderr, (time.perf_counter() - t0) * 1e3


def host_ms(fn, reps=3):
    """(result, median host ms of `reps` calls)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(ts))


def rel_err(a, b):
    return abs(a - b) / abs(b)


def model_body(path):
    """A model file's bytes, its comment line (it names the command) aside."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"#"))


def phase_interop(dev, workdir):
    """Phase 21 at N = 16384, q = 8 (the slice's data): (a) the native and
    Python SVM-light readers, bit for bit, and their share of a one-shot
    `gp learn -# 3`; (b) learn -f 1 from a .mat against -f 0; (c) .mat
    round trips of an FTC and a DTC (M = 1024) model; (d) fgp train
    ("rBw", and "lBw" for K4), retrain on a second draw, query of 8192 rows
    against GP.predict; (e) the daemon: learn -# 3 and log-likelihood
    through the client, twice, against the one-shot CLI."""
    import scipy.io as sio

    import importlib

    from gpc_tpu_torch.io import mat_io, svml
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.native import svml_native
    from gpc_tpu_torch.ops import cuda_lib

    # the module (interop/__init__ exports its function fgp under its name)
    fgp_api = importlib.import_module("gpc_tpu_torch.interop.fgp")
    X, y, rng = slice_data()
    data = os.path.join(workdir, "interop.svml")
    svml.write_svml(data, X, y)
    out = {}
    # (a) the readers
    native, out["native_read_ms"] = host_ms(lambda: svml_native.read(data))
    check(native is not None, "the native SVM-light reader did not build or load")
    py, out["python_read_ms"] = host_ms(lambda: svml.read_svml_py(data), reps=1)
    for a, b in zip(native, py):
        check(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b),
              "native and Python SVM-light readers disagree")
    check(np.array_equal(native[0], X) and np.array_equal(native[1], y),
          "the SVM-light file does not read back to its data")
    learn = ["-s", "1", "learn", "-#", "3"]
    rc, one_out, err, out["oneshot_learn_ms"] = run_proc(
        ["-m", "gpc_tpu_torch.cli.gp"] + learn + [data, "m_oneshot"], workdir)
    check(rc == 0, f"one-shot gp learn failed: {err[-2000:]}")
    for k in ("native", "python"):
        out[f"{k}_read_share"] = out[f"{k}_read_ms"] / out["oneshot_learn_ms"]
    log(f"phase 21(a) SVM-light N={N}: native {out['native_read_ms']} ms, Python "
        f"{out['python_read_ms']} ms, equal; one-shot gp learn -# 3 {out['oneshot_learn_ms']} "
        f"ms CLI wall: native {out['native_read_share']:.4%}, Python "
        f"{out['python_read_share']:.4%} of it")
    # (b) -f 1
    mat = os.path.join(workdir, "interop.mat")
    sio.savemat(mat, {"X": X, "y": y})
    finals = {}
    for fmt, src in ((0, data), (1, mat)):
        model_file = os.path.join(workdir, f"m_f{fmt}")
        text = run_cli(learn + ["-f", str(fmt), src, model_file])
        final, iters = learned(text)
        ll = float(run_cli(["log-likelihood", data, model_file]).split(":")[-1])
        check(iters == 3 and np.isfinite(ll), f"learn -f {fmt}: {iters} iterations, ll {ll}")
        finals[fmt] = (final, ll)
    for i, what in ((0, "final objective"), (1, "log-likelihood")):
        rel = rel_err(finals[1][i], finals[0][i])
        check(rel <= INTEROP_TOL, f"learn -f 1 vs -f 0 {what}: rel {rel}")
    out["f1_vs_f0"] = rel_err(finals[1][1], finals[0][1])
    log(f"phase 21(b) learn -# 3 -f 1 vs -f 0: log-likelihood {finals[1][1]} vs "
        f"{finals[0][1]} (rel {out['f1_vs_f0']})")
    # (c) .mat round trips on the card
    for approx in ("ftc", "dtc"):
        model = (GP(default_kern(Q), X, y, device=dev) if approx == "ftc"
                 else sparse_model(X, y, approx, dev))
        path = os.path.join(workdir, f"{approx}.mat")
        mat_io.write_gp_mat(path, model, X=X, y=y)
        back = mat_io.read_gp_mat(path, device=dev)
        check(back.device == model.device and back.spec.approx == approx, "read_gp_mat's model")
        ll, ll_back = model.log_likelihood(), back.log_likelihood()
        rel = rel_err(ll_back, ll)
        check(np.isfinite(ll) and rel <= INTEROP_TOL, f"{approx} .mat round trip: rel {rel}")
        out[f"mat_{approx}_rel"] = rel
        log(f"phase 21(c) {approx} .mat round trip: log-likelihood {ll_back} vs {ll} "
            f"(rel {rel})")
        torch.cuda.empty_cache()
    # (d) fgp
    fgp_api.clear()
    before = dict(cuda_lib.LAUNCHES)
    obj, out["fgp_train_ms"] = timed(lambda: fgp_api.train("rBw", X, y, iters=3))
    X2 = rng.standard_normal((N, Q))
    y2 = np.sin(X2.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((N, 1))
    obj2, out["fgp_retrain_ms"] = timed(lambda: fgp_api.retrain(X2, y2, iters=3))
    Xq = rng.standard_normal((CHUNK, Q))
    (mu, var), out["fgp_query_first_ms"] = timed(lambda: fgp_api.query(Xq, want_variance=True))
    _, out["fgp_query_ms"] = timed(lambda: fgp_api.query(Xq, want_variance=True))
    want_mu, want_var = fgp_api._state["model"].predict(Xq)
    check(np.isfinite(obj) and np.isfinite(obj2), f"fgp objectives {obj}, {obj2}")
    for name, got, want in (("mean", mu, want_mu), ("variance", var, want_var)):
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(err < SERVE_TOL, f"fgp query {name} vs GP.predict: rel {err}")
        out[f"fgp_{name}_err"] = err
    obj_l, out["fgp_train_lin_ms"] = timed(lambda: fgp_api.train("lBw", X, y, iters=1))
    check(np.isfinite(obj_l), f"fgp lBw objective {obj_l}")
    fgp_api.clear()
    out["fgp_launches"] = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
                           if v > before.get(k, 0)}
    for name in ("dist_gram", "inner_gram"):
        check(out["fgp_launches"].get(name, 0) > 0, f"fgp launched no {name}")
    log(f"phase 21(d) fgp N={N}: train rBw -# 3 {out['fgp_train_ms']} ms (objective {obj}), "
        f"retrain {out['fgp_retrain_ms']} ms ({obj2}), query {CHUNK} rows with variance "
        f"{out['fgp_query_first_ms']} ms (factor included), {out['fgp_query_ms']} ms after; "
        f"mean {out['fgp_mean_err']}, variance {out['fgp_variance_err']} of GP.predict; "
        f"train lBw -# 1 {out['fgp_train_lin_ms']} ms")
    torch.cuda.empty_cache()
    out.update(daemon_check(workdir, data, learn, one_out))
    return out


def daemon_check(workdir, data, learn, learn_ref):
    """Phase 21(e): a daemon server in a child process; its client's
    output and model files against the one-shot CLI's (`learn_ref` and
    m_oneshot, from (a))."""
    from gpc_tpu_torch.cli import daemon

    sock = os.path.join(workdir, "daemon.sock")
    env = repo_env(**{daemon.SOCKET_ENV: sock, "GPC_TPU_DAEMON_IDLE": "300"})
    ll = ["log-likelihood", data, "m_oneshot"]
    rc, ll_ref, err, oneshot_ll_ms = run_proc(["-m", "gpc_tpu_torch.cli.gp"] + ll, workdir)
    check(rc == 0, f"one-shot gp log-likelihood failed: {err[-2000:]}")
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "daemon.log"), "wb") as lf:
        server = subprocess.Popen([sys.executable, "-m", "gpc_tpu_torch.cli.daemon", "serve"],
                                  cwd=workdir, env=env, stdout=lf, stderr=lf,
                                  stdin=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + WAIT_S
        while not daemon._answering(sock):
            check(server.poll() is None and time.monotonic() < deadline,
                  "the daemon did not come up")
            time.sleep(0.05)
        start_ms = (time.perf_counter() - t0) * 1e3
        walls = []
        # the client by path imports no torch (`-m` imports the package first)
        client = [daemon.__file__, "run", "gp"]
        for i in (1, 2, 3):
            argv = (client if i < 3 else ["-m", "gpc_tpu_torch.cli.daemon", "run", "gp"])
            rc, text, err, ms = run_proc(argv + learn + [data, f"m_daemon{i}"], workdir, env)
            check(rc == 0 and text == learn_ref,
                  f"daemon learn #{i} differs from the one-shot CLI (rc {rc}): {err[-2000:]}")
            check(model_body(os.path.join(workdir, f"m_daemon{i}"))
                  == model_body(os.path.join(workdir, "m_oneshot")),
                  f"daemon learn #{i}: the model file differs from the one-shot CLI's")
            walls.append(ms)
        ll_walls = []
        for i in (1, 2):
            rc, text, err, ms = run_proc(client + ll, workdir, env)
            check(rc == 0 and text == ll_ref, f"daemon log-likelihood #{i}: {text!r} vs {ll_ref!r}")
            ll_walls.append(ms)
        rc, _, err, _ = run_proc([daemon.__file__, "stop"], workdir, env)
        check(rc == 0, f"daemon stop: {err[-2000:]}")
        check(server.wait(timeout=WAIT_S) == 0, "the daemon did not exit cleanly")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait(timeout=WAIT_S)
    out = dict(daemon_start_ms=start_ms, daemon_first_learn_ms=walls[0],
               daemon_warm_learn_ms=walls[1], daemon_warm_learn_module_client_ms=walls[2],
               oneshot_ll_ms=oneshot_ll_ms, daemon_first_ll_ms=ll_walls[0],
               daemon_warm_ll_ms=ll_walls[1])
    log(f"phase 21(e) daemon: server up in {start_ms} ms; learn -# 3 CLI wall: first "
        f"{walls[0]} ms, warm {walls[1]} ms, warm with the client run by -m {walls[2]} ms "
        f"(one-shot measured in (a)); log-likelihood: "
        f"one-shot {oneshot_ll_ms} ms, daemon first {ll_walls[0]} ms, warm {ll_walls[1]} ms; "
        f"output and model files equal to the one-shot CLI's")
    return out


def warm_median(fn, reps=3):
    """(result, median ms of `reps` timed calls after one warm-up call)."""
    fn()
    runs = [timed(fn) for _ in range(reps)]
    return runs[-1][0], float(np.median([ms for _, ms in runs]))


@contextlib.contextmanager
def world_one(dev, workdir):
    """The world-size-1 group of phases 22 and 23 (NCCL on the card),
    started from a file store; yields its data mesh."""
    import torch.distributed as dist

    from gpc_tpu_torch.parallel.mesh import backend_for, data_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(backend_for(dev), init_method=f"file://{os.path.join(workdir, 'store')}",
                            world_size=1, rank=0)
    try:
        mesh = data_mesh(dev)
        check(mesh.size == 1 and mesh.device.type == dev.type, f"mesh {mesh}")
        yield mesh
    finally:
        dist.destroy_process_group()


def phase_dist(dev, workdir, mesh):
    """Phase 22: the distributed layer at world size 1 on NCCL (`mesh`, the
    group world_one starts).  make_dist_objective (FTC at N = 16384;
    DTC, DTCVAR, FITC at M = 1024) against the single-process model; 3 SCG
    iterations of make_dist_train_step (DTC); GPServer(mesh=) against
    GPServer; load_svml_sharded against read_svml.  Its two ranks on the
    one card over gloo run in gloo_two_ranks, after phase 23."""
    import torch.distributed as dist

    from gpc_tpu_torch.io import svml
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel import multihost
    from gpc_tpu_torch.parallel.dist_gp import make_dist_objective, make_dist_train_step
    from gpc_tpu_torch.parallel.mesh import shard_rows
    from gpc_tpu_torch.serving import GPServer

    X, y, rng = slice_data()
    out = {}
    # the backend's communicator starts at the first collective
    _, out["first_collective_ms"] = timed(
        lambda: dist.all_reduce(torch.ones(1, device=mesh.device)))
    mask = np.ones(N)
    Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, mask))
    for approx in ("ftc", "dtc", "dtcvar", "fitc"):
        model = (GP(default_kern(Q), X, y, device=dev) if approx == "ftc"
                 else sparse_model(X, y, approx, dev))
        nlml = make_dist_objective(model.spec, mesh, model.bias, model.fixed_scales, N)
        vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
        vag0 = model.value_and_grad_fn()
        (f, g), ms = warm_median(lambda: vag(model.theta))
        (f0, g0), ms0 = warm_median(lambda: vag0(model.theta))
        tol_f, tol_g = DIST_FTC_TOL if approx == "ftc" else DIST_SPARSE_TOL
        rf, rg = rel_err(f, f0), rel_l2(g, g0)
        check(np.isfinite(f) and rf <= tol_f and rg <= tol_g,
              f"dist {approx} vs single: value rel {rf}, θ̄ rel L2 {rg}")
        out[approx] = dict(value_rel=rf, grad_rel_l2=rg, dist_vag_ms=ms, single_vag_ms=ms0)
        log(f"phase 22 dist {approx} world 1: value {f} vs {f0} (rel {rf}), θ̄ rel L2 {rg}; "
            f"value_and_grad {ms} ms vs single {ms0} ms (median of 3 after a warm-up)")
        del model, nlml, vag, vag0
        torch.cuda.empty_cache()
    # SCG at the full cell rejects its first steps (the reference's δ
    # update, PERF.md §6), so a cut of the cell where it moves too
    for n, M in ((N, M_SPARSE), (SCG_ROWS, SCG_M)):
        model = sparse_model(X[:n], y[:n], "dtc", dev, M=M)
        step = make_dist_train_step(model.spec, mesh, model.bias, model.fixed_scales, n)
        f_start = model.value_and_grad_fn()(model.theta)[0]
        parts = (shard_rows(mesh, a[:n]) for a in (X, y, mask))
        res, scg_ms = timed(lambda: step(model.theta, *parts, 3))
        ref = model.optimise(iters=3)
        ro, rx = rel_err(res.obj, ref.obj), rel_l2(res.x, ref.x)
        tol = DIST_SCG_TOL if n == N else DIST_SCG_MOVING_TOL
        check(res.iters == ref.iters and res.obj <= f_start and ro <= tol[0]
              and rx <= tol[1],
              f"dist SCG vs single at N={n}: iterations {res.iters}/{ref.iters}, "
              f"objective rel {ro}, θ rel L2 {rx}")
        out[f"scg_n{n}"] = dict(start=f_start, obj=res.obj, obj_rel=ro, theta_rel_l2=rx,
                                ms=scg_ms)
        log(f"phase 22 dist SCG (DTC, N={n}, M={M}) -# 3: objective {f_start} -> {res.obj} "
            f"vs single {ref.obj} (rel {ro}), θ rel L2 {rx}, {scg_ms} ms")
    model = GP(default_kern(Q), X, y, device=dev)
    plain = GPServer(model, chunk=CHUNK)
    meshed = GPServer(model, chunk=CHUNK, mesh=mesh)
    worst = 0.0
    for t in (CHUNK, 1000, 37):
        Xt = rng.standard_normal((t, Q))
        for a, b in zip(meshed.predict(Xt), plain.predict(Xt)):
            worst = max(worst, float(np.abs(a - b).max()))
    check(worst <= 1e-6, f"GPServer(mesh=) vs GPServer: {worst}")
    out["server_max_abs_diff"] = worst
    data = os.path.join(workdir, "interop.svml")       # written by phase 21
    Xs, ys, n_valid = multihost.load_svml_sharded(data, mesh)
    Xr, yr = svml.read_svml(data)
    check(n_valid == N and np.array_equal(Xs, Xr) and np.array_equal(ys, yr),
          "load_svml_sharded differs from read_svml")
    log(f"phase 22 GPServer(mesh=) vs GPServer on {CHUNK}/1000/37 rows: max |diff| {worst}; "
        f"load_svml_sharded equals read_svml")
    return out


# ---------------------------------------------------------------------------
# phase 23: the rest of the distributed layer
# ---------------------------------------------------------------------------

DIST_POST_ROWS = 8192                 # the posterior's test rows, 23(a)
DIST_GPLVM_TOL = (1e-4, 1e-3)         # phase 19's limits: value, θ̄ relative L2
GPDM_BREAKS = (0, 1250, 3000)         # phase 20's breaks, scaled to GPLVM_SMALL rows
DIST_ITER_LD_TOL = 1e-3               # dist logdet against the single process's, same probes
GLOO_FTC_N = 4096                     # dist_ftc at two ranks: two panels of 2048
# gpc_tpu's non-whitened 2-D sparse forms (A = K_uu/β + K_uf·K_fu) against
# the CPU float64 route: value and θ̄ (relative L2) of the rbf cell, and the
# -k mlp value.  κ(A) is 1.5e6 (rbf) and 6.3e6 (mlp) at this θ against
# 1.9e3 and 4.3e3 for the single process's whitened form, so float32 misses
# phase 17's limits: on an H100 80GB HBM3 at 700 W the first run read DTC /
# DTCVAR 1.15e-5 / 8.7e-6 on the value, 1.5e-4 / 1.4e-4 on θ̄, and 2.0e-4 on
# the mlp value, while the same form in float64 on the CPU is within 7.5e-16
# of the route and FITC (factored in L_uu⁻¹ space) 9.5e-9.  The limits were
# set after that reading (PERF.md §6).
DIST2D_TOL = (5e-5, 1e-3)
DIST2D_MLP_TOL = 1e-3
SCALING_ROWS, SCALING_M = 2048, 256   # scaling_bench.run's defaults (gpc_tpu's)
# phase 23's kernel launches, each distributed call's own: {module: Counter};
# the single-process references beside those calls are not in it
DIST2_LAUNCHES: dict = {}
DIST2_MODULES = ("dist_ftc", "dist_gplvm", "dist_iterative", "dist_ivm", "dist_sparse2d",
                 "scaling_bench")


def dist2_call(module, fn):
    """fn() with the kernel counts set to 0 just before it and read just
    after, added to DIST2_LAUNCHES[module].  The counts from before come
    back after it, so a reader around the call (iterative_check's K1
    count) still sees them."""
    from gpc_tpu_torch.ops import cuda_lib
    outer = collections.Counter(cuda_lib.LAUNCHES)
    cuda_lib.LAUNCHES.clear()
    out = fn()
    DIST2_LAUNCHES.setdefault(module, collections.Counter()).update(cuda_lib.LAUNCHES)
    cuda_lib.LAUNCHES.update(outer)
    return out


def check_dist2_launches(where, modules, mlp):
    """Each of `modules` launched K1 in its own calls (DIST2_LAUNCHES), and
    the 2-D mesh K4 where it ran -k mlp."""
    for module in modules:
        check(DIST2_LAUNCHES.get(module, {}).get("dist_gram", 0) > 0,
              f"{where}: kernel dist_gram was not launched by {module}")
    if mlp:
        check(DIST2_LAUNCHES.get("dist_sparse2d", {}).get("inner_gram", 0) > 0,
              f"{where}: kernel inner_gram was not launched by dist_sparse2d -k mlp")


def peak_of(fn):
    """(fn(), peak GiB allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def cpu_mesh_2d():
    """A (1, 1) mesh of a gloo group on the CPU beside the card's NCCL
    group: the float64 route of the 2-D form (same code, same θ)."""
    import torch.distributed as dist

    from gpc_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS, Mesh, Mesh2D
    g = dist.new_group([0], backend="gloo")
    cpu = torch.device("cpu")
    return Mesh2D(mp=Mesh(group=g, rank=0, size=1, device=cpu, axis=MP_AXIS),
                  dp=Mesh(group=g, rank=0, size=1, device=cpu, axis=DP_AXIS), device=cpu)


def dist2_ftc(dev, mesh):
    """23(a): dist_ftc / evidence_distributed on the slice (N = 16384,
    q = 8, one panel at world 1): value and θ̄ against the single-process
    dense model (DIST_FTC_TOL), value_and_grad ms (median of 3 after a
    warm-up) and peak GiB beside it; the posterior of 8192 rows against
    GP.predict (SERVE_TOL of each output's largest entry)."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_ftc import (make_dist_ftc_posterior,
                                                 make_dist_ftc_value_and_grad)
    from gpc_tpu_torch.parallel.mesh import shard_rows
    X, y, rng = slice_data()
    model = GP(default_kern(Q), X, y, device=dev)
    Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, np.ones(N)))
    nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, N)
    vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
    ((f, g), ms), gib = peak_of(lambda: dist2_call(
        "dist_ftc", lambda: warm_median(lambda: vag(model.theta))))
    torch.cuda.empty_cache()
    vag0 = model.value_and_grad_fn()
    ((f0, g0), ms0), gib0 = peak_of(lambda: warm_median(lambda: vag0(model.theta)))
    torch.cuda.empty_cache()
    rf, rg = rel_err(f, f0), rel_l2(g, g0)
    out = dict(value=f, single_value=f0, value_rel=rf, grad_rel_l2=rg, dist_vag_ms=ms,
               single_vag_ms=ms0, dist_peak_gib=gib, single_peak_gib=gib0)
    log(f"phase 23(a) dist_ftc N={N} q={Q}: {json.dumps(out)}")
    check(np.isfinite(f) and rf <= DIST_FTC_TOL[0] and rg <= DIST_FTC_TOL[1],
          f"dist_ftc vs single: value rel {rf}, θ̄ rel L2 {rg}")
    Xt = rng.standard_normal((DIST_POST_ROWS, Q))
    post = make_dist_ftc_posterior(model.spec, mesh, model.bias, model.fixed_scales, N)
    theta = as_tensor(model.theta, dev)
    (mu, var), post_ms = dist2_call("dist_ftc", lambda: timed(
        lambda: post(theta, Xl, yl, ml, as_tensor(Xt, dev))))
    (mu0, var0), pred_ms = timed(lambda: model.predict(Xt))
    errs = {name: float(np.abs(a.cpu().numpy() - b).max() / np.abs(b).max())
            for name, a, b in (("mean", mu, mu0), ("variance", var, var0))}
    out.update(posterior_ms=post_ms, predict_ms=pred_ms, posterior_rel=errs)
    log(f"phase 23(a) dist_ftc posterior of {DIST_POST_ROWS} rows: {post_ms} ms (GP.predict "
        f"{pred_ms} ms), max |diff| relative to the largest entry {errs}")
    check(all(e < SERVE_TOL for e in errs.values()), f"dist_ftc posterior vs predict: {errs}")
    return out


def dist2_gplvm(dev, mesh):
    """23(b): dist_gplvm against the single-process dense GPLVM
    (DIST_GPLVM_TOL): the plain bench model at N = 16384, D = 4, q = 2,
    and on the first 4096 rows the GPDM (cmpnd(rbf, bias, white) dynamics,
    breaks GPDM_BREAKS) and the back-constrained model (bK the rbf Gram of
    Y from K1, as `gplvm learn -c rbf` builds it; A drawn as -I rand);
    value_and_grad ms (median of 3 after a warm-up) of each."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch import kernels as KM
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_gplvm import make_dist_gplvm_value_and_grad
    from gpc_tpu_torch.parallel.mesh import shard_rows
    Y, _ = gplvm_data()
    Ys, _ = gplvm_data(GPLVM_SMALL)
    back = KM.Rbf(input_dim=GPLVM_D)
    with torch.no_grad():
        bK = back.gram(as_tensor(back.default_params(), dev), as_tensor(Ys, dev))
    bK = bK.double().cpu().numpy()
    cases = (("plain", Y, {}),
             ("gpdm", Ys, dict(dyn_kern=default_kern(GPLVM_Q), dyn_breaks=GPDM_BREAKS)),
             ("back", Ys, dict(back_kernel_matrix=bK, init="rand", seed=3)))
    out = {}
    for tag, Yc, kw in cases:
        model = gplvm_model(Yc, dev, **kw)
        vag_d = make_dist_gplvm_value_and_grad(model.spec, mesh, model.noise_bias,
                                               model.fixed_scales, model.dyn_params_fixed)
        args = [shard_rows(mesh, Yc)] + ([shard_rows(mesh, bK)] if tag == "back" else [])
        vag = numpy_value_and_grad(lambda t: vag_d(t, *args), mesh.device)
        (f, g), ms = dist2_call("dist_gplvm", lambda: warm_median(lambda: vag(model.theta)))
        with evidence_env("dense"):
            (f0, g0), ms0 = warm_median(lambda: model.value_and_grad_fn()(model.theta))
        rf, rg = rel_err(f, f0), rel_l2(g, g0)
        out[tag] = dict(n=Yc.shape[0], value=f, single_value=f0, value_rel=rf, grad_rel_l2=rg,
                        dist_vag_ms=ms, single_vag_ms=ms0)
        log(f"phase 23(b) dist_gplvm {tag}: {json.dumps(out[tag])}")
        check(np.isfinite(f) and rf <= DIST_GPLVM_TOL[0] and rg <= DIST_GPLVM_TOL[1],
              f"dist_gplvm {tag} vs single: value rel {rf}, θ̄ rel L2 {rg}")
        del model, vag
        torch.cuda.empty_cache()
    return out


def dist2_iterative(dev, mesh):
    """23(c): dist_iterative on the slice (N = 16384, q = 8, the engine's
    defaults) with the single-process engine's probes: quad within the
    bound its CG residual gives and logdet within 0.05 of float64
    (iterative_check), logdet within DIST_ITER_LD_TOL of the single
    process's estimate on the same probes; CG iterations, K1 launches and
    ms of both evidences; dist_iterative_nlml's value and θ̄ against the
    single process's iterative value_and_grad (DIST_FTC_TOL), ms of both."""
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.ops import iterative as TI
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_iterative import (dist_iterative_nlml,
                                                       make_dist_iterative_evidence)
    from gpc_tpu_torch.parallel.mesh import shard_rows
    X, y, _ = slice_data()
    gp = GP(default_kern(Q), X, y, device=dev)
    theta, Xd, yd, bias, scales = gp._args()
    _, kp, _, _ = gp.spec.unpack(theta)
    m = (yd - bias) / scales
    kern = gp.spec.kern
    single = iterative_check("single-process FTC N=16384 q=8", kern, kp, Xd, m, phase="23(c)")
    ev = make_dist_iterative_evidence(kern, mesh)
    Xl, ml, kl = (shard_rows(mesh, a) for a in (X, m.cpu().numpy(), np.ones(N)))
    rec = iterative_check("dist FTC N=16384 q=8", kern, kp, Xd, m, phase="23(c)",
                          evidence=lambda: dist2_call("dist_iterative",
                                                      lambda: ev(kp, Xl, ml, kl)))
    rel = abs(rec["logdet"] - single["logdet"]) / abs(single["logdet"])
    out = dict(dist=rec, single=single, logdet_rel_to_single=rel)
    check(rel <= DIST_ITER_LD_TOL, f"dist iterative logdet vs single: rel {rel}")
    nlml = dist_iterative_nlml(kern, mesh, gp.bias, gp.fixed_scales, N)
    yl = shard_rows(mesh, y)
    (f, g), out["dist_vag_ms"] = dist2_call("dist_iterative", lambda: timed(
        lambda: numpy_value_and_grad(lambda t: nlml(t, Xl, yl, kl), dev)(gp.theta)))
    with evidence_env("iterative"):
        (f0, g0), out["single_vag_ms"] = timed(lambda: gp.value_and_grad_fn()(gp.theta))
    out.update(value_rel=rel_err(f, f0), grad_rel_l2=rel_l2(g, g0))
    check(np.isfinite(f) and np.isfinite(g).all() and out["value_rel"] <= DIST_FTC_TOL[0]
          and out["grad_rel_l2"] <= DIST_FTC_TOL[1],
          f"dist iterative value_and_grad vs single (same probes): value rel "
          f"{out['value_rel']}, θ̄ rel L2 {out['grad_rel_l2']}")
    log(f"phase 23(c) dist_iterative: logdet rel to single {rel}; value_and_grad "
        f"{out['dist_vag_ms']} ms vs single {out['single_vag_ms']} ms, value rel "
        f"{out['value_rel']}, θ̄ rel L2 {out['grad_rel_l2']}")
    return out


def ivm_order_check(tag, model, order, order0):
    """A distributed selection order against the single process's graph:
    the picks that differ, and, where any do, the order replayed through
    the CPU float64 step with each pick within IVM_GAP_TOL of its step's
    maximum."""
    from gpc_tpu_torch.models.ivm import replay
    X, y = ivm_select_data()
    differ = int((np.asarray(order) != np.asarray(order0)).sum())
    rec = dict(picks_differing_from_graph=differ)
    check(len(set(np.asarray(order).tolist())) == IVM_D, f"{tag}: a point picked twice")
    if differ:
        first = int(np.argmax(np.asarray(order) != np.asarray(order0)))
        (_, gaps), replay_ms = timed(lambda: replay(
            model.spec, model.kern_params, model.noise_params, torch.as_tensor(X),
            torch.as_tensor(y), np.asarray(order)))
        rec.update(first_differing_step=first, worst_gap_rel=float(gaps.max()),
                   replay_cpu_f64_ms=replay_ms)
        check(float(gaps.max()) <= IVM_GAP_TOL,
              f"{tag}: a pick's f64 score is {float(gaps.max())} below the step's maximum")
    return rec


def dist2_ivm(dev, mesh):
    """23(d): make_select_points_dist at phase 18's geometry (N = 4096,
    d = 512) against the single-process graph's order (ivm_order_check);
    points/s of both (median of 3 passes after a warm-up).  Returns the
    record and the graph's order and model (for 23(f))."""
    from gpc_tpu_torch.models.ivm import IVM
    from gpc_tpu_torch.noise import GaussianNoise
    from gpc_tpu_torch.parallel.dist_ivm import make_select_points_dist
    from gpc_tpu_torch.parallel.mesh import shard_rows
    X, y = ivm_select_data()
    model = IVM(default_kern(IVM_Q), GaussianNoise(output_dim=1), X, y, num_active=IVM_D,
                device=dev)
    st0, graph_ms = warm_median(model.init_and_select)
    order0 = st0.active_idx.cpu().numpy()
    select = make_select_points_dist(model.spec, mesh)
    args = [shard_rows(mesh, a) for a in (X, y, np.ones(IVM_N))]
    st, ms = dist2_call("dist_ivm", lambda: warm_median(
        lambda: select(model.kern_params, model.noise_params, *args, np.zeros(IVM_D))))
    out = dict(points_per_s=IVM_D / ms * 1e3, pass_ms=ms,
               graph_points_per_s=IVM_D / graph_ms * 1e3, graph_pass_ms=graph_ms,
               **ivm_order_check("dist_ivm world 1", model, st.active_idx.cpu().numpy(), order0))
    log(f"phase 23(d) dist_ivm N={IVM_N} d={IVM_D}: {json.dumps(out)}")
    return out, order0, model


def dist2_sparse2d(dev, X, y):
    """23(e): make_dist2d_objective on mesh_2d(1, 1) at phase 17's cell
    (N = 16384, M = 1024): DTC, DTCVAR, FITC value and θ̄ against the CPU
    float64 route (DIST2D_TOL), value_and_grad ms beside the single-process
    model's on the card; the float64 value of the same 2-D form on the CPU
    (cpu_mesh_2d) beside it, and one DTC evaluation with -k mlp (K4)
    against the CPU float64 route (DIST2D_MLP_TOL).  Returns the record and the
    float64 references (for 23(f))."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_sparse2d import make_dist2d_objective, shard_data_2d
    from gpc_tpu_torch.parallel.mesh import mesh_2d
    m2, mc = mesh_2d(1, 1, dev), cpu_mesh_2d()
    args = [shard_data_2d(m2, a) for a in (X, y, np.ones(N))]
    args_c = [shard_data_2d(mc, a) for a in (X, y, np.ones(N))]
    out, refs = {}, {}
    for approx in ("dtc", "dtcvar", "fitc"):
        card, cpu = sparse_model(X, y, approx, dev), sparse_model(X, y, approx, "cpu")
        nlml = make_dist2d_objective(card.spec, m2, card.bias, card.fixed_scales, N)
        (f, g), ms = dist2_call("dist_sparse2d", lambda: warm_median(
            lambda: numpy_value_and_grad(lambda t: nlml(t, *args), dev)(card.theta)))
        (f1, g1), ms1 = warm_median(lambda: card.value_and_grad_fn()(card.theta))
        (f64, g64), cpu_ms = timed(lambda: cpu.value_and_grad_fn()(cpu.theta))
        nlml_c = make_dist2d_objective(cpu.spec, mc, cpu.bias, cpu.fixed_scales, N)
        with torch.no_grad():
            f64_2d = float(nlml_c(torch.as_tensor(cpu.theta), *args_c))
        refs[approx] = dict(value=f64, grad=g64.tolist())
        rec = dict(value=f, value_f64=f64, value_rel=rel_err(f, f64), grad_rel_l2=rel_l2(g, g64),
                   single_value_rel=rel_err(f1, f64), single_grad_rel_l2=rel_l2(g1, g64),
                   form_2d_f64_value_rel=rel_err(f64_2d, f64), dist_vag_ms=ms,
                   single_vag_ms=ms1, cpu_f64_vag_ms=cpu_ms)
        out[approx] = rec
        log(f"phase 23(e) dist_sparse2d 1x1 {approx} N={N} M={M_SPARSE}: {json.dumps(rec)}")
        check(np.isfinite(f) and rec["value_rel"] <= DIST2D_TOL[0]
              and rec["grad_rel_l2"] <= DIST2D_TOL[1],
              f"dist_sparse2d {approx} vs CPU f64: value rel {rec['value_rel']}, θ̄ rel L2 "
              f"{rec['grad_rel_l2']}")
        del card, cpu, nlml, nlml_c
        torch.cuda.empty_cache()
    for lead in ("rbf", "mlp"):
        out[f"dtc_conditions_{lead}"] = dtc_conditions(sparse_model(X, y, "dtc", "cpu",
                                                                    lead=lead))
    log(f"phase 23(e) κ of DTC's A (gpc_tpu's 2-D form) and of the whitened Am, float64: "
        f"{json.dumps({k: v for k, v in out.items() if k.startswith('dtc_cond')})}")
    card = sparse_model(X, y, "dtc", dev, lead="mlp")
    nlml = make_dist2d_objective(card.spec, m2, card.bias, card.fixed_scales, N)
    with torch.no_grad():
        f = float(dist2_call("dist_sparse2d", lambda: nlml(as_tensor(card.theta, dev), *args)))
    f64 = -sparse_model(X, y, "dtc", "cpu", lead="mlp").log_likelihood()
    out["dtc_mlp"] = dict(value=f, value_f64=f64, value_rel=rel_err(f, f64))
    log(f"phase 23(e) dist_sparse2d 1x1 DTC -k mlp: {json.dumps(out['dtc_mlp'])}")
    check(rel_err(f, f64) <= DIST2D_MLP_TOL,
          f"dist_sparse2d DTC mlp vs CPU f64: {out['dtc_mlp']}")
    return out, refs


def dtc_conditions(model):
    """The condition numbers of DTC's A = K_uu/β + K_uf·K_fu (gpc_tpu's
    2-D form) and of the whitened Am = I/β + W·Wᵀ (the single process's) at
    the model's θ, in float64 on the CPU."""
    from gpc_tpu_torch import linalg
    X_u, kp, _, beta = model.spec.unpack(torch.as_tensor(model.theta))
    K_uu = model.spec.kern.gram(kp, X_u)
    K_uf = model.spec.kern.compute(kp, X_u, torch.as_tensor(model.X))
    W = linalg.tri_solve(linalg.jitchol(K_uu)[0], K_uf)
    eye = torch.eye(K_uu.shape[0], dtype=K_uu.dtype)

    def cond(A):
        ev = torch.linalg.eigvalsh(A)
        return float(ev[-1] / ev[0])
    return dict(A=cond(K_uu / beta + K_uf @ K_uf.T), Am_whitened=cond(eye / beta + W @ W.T))


def dist2_scaling(mesh):
    """23(g), world 1: scaling_bench.run (DTC value_and_grad at 2048 rows
    a rank, M = 256) and the census of one dist_ftc value_and_grad
    (weak_scaling_artifact, 128 rows a rank)."""
    from gpc_tpu_torch.parallel import scaling_bench
    line = dist2_call("scaling_bench", lambda: scaling_bench.run(SCALING_ROWS, SCALING_M,
                                                                 mesh=mesh))
    art = dist2_call("scaling_bench", lambda: scaling_bench.weak_scaling_artifact(mesh.size,
                                                                                  mesh=mesh))
    log(f"phase 23(g) scaling_bench world 1 (NCCL): {json.dumps(line)}; weak-scaling record "
        f"{json.dumps(art)}")
    check(line["t_ms"] > 0 and "all-gather" in art["weak_scaling_proxy"]["collectives_measured"],
          f"scaling_bench world 1: {line}")
    return dict(run=line, artifact=art)


def phase_dist2(dev, workdir, mesh):
    """Phase 23: the rest of the distributed layer at world 1 on NCCL
    (23(a)-(e), (g) world 1); writes the float64 sparse references and the
    graph's IVM order for gloo_two_ranks (23(f), (g) world 2)."""
    out = dict(ftc=dist2_ftc(dev, mesh))
    torch.cuda.empty_cache()
    out["gplvm"] = dist2_gplvm(dev, mesh)
    torch.cuda.empty_cache()
    out["iterative"] = dist2_iterative(dev, mesh)
    torch.cuda.empty_cache()
    out["ivm"], order0, ivm_model = dist2_ivm(dev, mesh)
    torch.cuda.empty_cache()
    X, y, _ = slice_data()
    out["sparse2d"], refs = dist2_sparse2d(dev, X, y)
    torch.cuda.empty_cache()
    out["scaling"] = dist2_scaling(mesh)
    with open(os.path.join(workdir, "dist2_refs.json"), "w") as f:
        json.dump(dict(sparse2d=refs, ivm_order=order0.tolist()), f)
    return out, ivm_model, order0


def gloo_two_ranks(workdir):
    """Two ranks on the one card over gloo with CUDA tensors, each a child
    process (`chip_smoke.py --gloo-rank R STORE REFS`): phase 22's DTC
    (all_reduce) and FTC (all_gather too) objectives and θ̄ against the
    single-process model, and phase 23(f)-(g)'s dist_ftc, dist_sparse2d,
    dist_ivm and scaling_bench at world 2.  Returns rank 0's record."""
    store = os.path.join(workdir, "gloo_store")
    refs = os.path.join(workdir, "dist2_refs.json")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
                               store, refs], cwd=workdir, env=repo_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=WAIT_S)
            check(p.returncode == 0, f"gloo rank failed: {e[-3000:]}")
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT_S)
    check(outs[0]["ivm_order"] == outs[1]["ivm_order"], "the gloo ranks' IVM orders differ")
    return outs[0]


def gloo_rank_main(rank, store, refs_path):
    """One rank of gloo_two_ranks; prints one JSON line."""
    import torch.distributed as dist

    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_gp import make_dist_objective
    from gpc_tpu_torch.parallel.mesh import data_mesh, shard_rows

    require_card()
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    mesh = data_mesh()
    res = {}
    t = torch.ones(4, device=mesh.device)
    for name, op in (("all_reduce", lambda: dist.all_reduce(t.clone())),
                     ("all_gather", lambda: dist.all_gather([torch.empty_like(t) for _ in (0, 1)],
                                                            t)),
                     ("broadcast", lambda: dist.broadcast(t.clone(), src=0))):
        try:
            op()
            res[name] = "ok"
        except RuntimeError as e:       # the backend refuses CUDA tensors
            res[name] = "refused: " + str(e).splitlines()[0][:200]
    check(all(v == "ok" for v in res.values()), f"gloo on CUDA tensors: {res}")
    X, y, _ = slice_data()
    Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, np.ones(N)))
    # phase 22: DTC needs all_reduce; FTC all_gather too
    for approx, (tol_f, tol_g) in (("dtc", DIST_SPARSE_TOL), ("ftc", DIST_FTC_TOL)):
        model = (sparse_model(X, y, approx, mesh.device) if approx == "dtc"
                 else GP(default_kern(Q), X, y, device=mesh.device))
        nlml = make_dist_objective(model.spec, mesh, model.bias, model.fixed_scales, N)
        vag = numpy_value_and_grad(lambda th: nlml(th, Xl, yl, ml), mesh.device)
        (f, g), ms = warm_median(lambda: vag(model.theta))
        f0, g0 = model.value_and_grad_fn()(model.theta)
        rf, rg = rel_err(f, f0), rel_l2(g, g0)
        check(rf <= tol_f and rg <= tol_g,
              f"gloo rank {rank}: {approx} value rel {rf}, θ̄ rel L2 {rg}")
        res.update({f"{approx}_value_rel": rf, f"{approx}_grad_rel_l2": rg,
                    f"{approx}_vag_ms": ms})
        del model, nlml, vag
        torch.cuda.empty_cache()
    with open(refs_path) as f:
        refs = json.load(f)
    res.update(gloo_dist2(rank, mesh, refs))
    dist.destroy_process_group()
    print(json.dumps(res), flush=True)


def gloo_dist2(rank, mesh, refs):
    """23(f)-(g) on a gloo rank of two: dist_ftc at N = 4096 (two panels)
    against the single process (DIST_FTC_TOL); dist_sparse2d on (2, 1) and
    (1, 2) against the parent's float64 references (DIST2D_TOL); dist_ivm's
    order (checked by the parent); scaling_bench.run at world 2."""
    from gpc_tpu_torch.models.gp import GP
    from gpc_tpu_torch.models.ivm import IVM
    from gpc_tpu_torch.noise import GaussianNoise
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel import scaling_bench
    from gpc_tpu_torch.parallel.dist_ftc import make_dist_ftc_value_and_grad
    from gpc_tpu_torch.parallel.dist_ivm import make_select_points_dist
    from gpc_tpu_torch.parallel.dist_sparse2d import make_dist2d_objective, shard_data_2d
    from gpc_tpu_torch.parallel.mesh import mesh_2d, shard_rows
    dev = mesh.device
    X, y, _ = slice_data()
    res = {}
    n = GLOO_FTC_N
    model = GP(default_kern(Q), X[:n], y[:n], device=dev)
    nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, n)
    parts = [shard_rows(mesh, a) for a in (X[:n], y[:n], np.ones(n))]
    (f, g), ms = dist2_call("dist_ftc", lambda: warm_median(lambda: numpy_value_and_grad(
        lambda t: nlml(t, *parts), dev)(model.theta)))
    (f0, g0), ms0 = warm_median(lambda: model.value_and_grad_fn()(model.theta))
    res["dist_ftc"] = dict(n=n, value_rel=rel_err(f, f0), grad_rel_l2=rel_l2(g, g0),
                           dist_vag_ms=ms, single_vag_ms=ms0)
    check(res["dist_ftc"]["value_rel"] <= DIST_FTC_TOL[0]
          and res["dist_ftc"]["grad_rel_l2"] <= DIST_FTC_TOL[1],
          f"gloo rank {rank}: dist_ftc N={n}: {res['dist_ftc']}")
    for grid in ((2, 1), (1, 2)):
        m2 = mesh_2d(*grid, dev)
        args = [shard_data_2d(m2, a) for a in (X, y, np.ones(N))]
        for approx in ("dtc", "dtcvar", "fitc"):
            card = sparse_model(X, y, approx, dev)
            nlml2 = make_dist2d_objective(card.spec, m2, card.bias, card.fixed_scales, N)
            (f, g), ms = dist2_call("dist_sparse2d", lambda: timed(lambda: numpy_value_and_grad(
                lambda t: nlml2(t, *args), dev)(card.theta)))
            ref = refs["sparse2d"][approx]
            rec = dict(value_rel=rel_err(f, ref["value"]),
                       grad_rel_l2=rel_l2(g, np.asarray(ref["grad"])), vag_ms=ms)
            res[f"sparse2d_{grid[0]}x{grid[1]}_{approx}"] = rec
            check(rec["value_rel"] <= DIST2D_TOL[0] and rec["grad_rel_l2"] <= DIST2D_TOL[1],
                  f"gloo rank {rank}: dist_sparse2d {grid} {approx} vs CPU f64: {rec}")
            del card, nlml2
            torch.cuda.empty_cache()
    Xi, yi = ivm_select_data()
    ivm = IVM(default_kern(IVM_Q), GaussianNoise(output_dim=1), Xi, yi, num_active=IVM_D,
              device=dev)
    select = make_select_points_dist(ivm.spec, mesh)
    args = [shard_rows(mesh, a) for a in (Xi, yi, np.ones(IVM_N))]
    st, ms = dist2_call("dist_ivm", lambda: timed(
        lambda: select(ivm.kern_params, ivm.noise_params, *args, np.zeros(IVM_D))))
    res["ivm_order"] = st.active_idx.cpu().numpy().tolist()
    res["ivm"] = dict(pass_ms=ms, points_per_s=IVM_D / ms * 1e3)
    res["scaling"] = dist2_call("scaling_bench",
                                lambda: scaling_bench.run(SCALING_ROWS, SCALING_M, mesh=mesh))
    check_dist2_launches(f"gloo rank {rank}", ("dist_ftc", "dist_sparse2d", "dist_ivm",
                                               "scaling_bench"), mlp=False)
    res["dist2_launches"] = DIST2_LAUNCHES
    return res


BENCH_F32_TOL = 1e-4      # f32 engines against the dense f32 evidence: PERF.md §2's lazy limit
BENCH_BF16_TOL = 1e-2     # bf16 engines: gpc_tpu's bench drift gate (bench.py:216)
BENCH_CPU_ROWS = 2048     # the CPU float64 route's cut
BENCH_GRAD_TOL = 1e-3     # θ̄ relative L2 against dense autograd: PERF.md §2's FTC limit
BENCH_GRAD_POLICY = (256, False, "xla", True)   # differentiable: leafinv "xla"


def bench_kernels(dev, X):
    """K1 on the flat schedule's tallest column block ((N − 512) × 512) and
    a diagonal block, and K5 on the first 512-leaf, against their plain
    versions (K1 rtol 1e-5 as phase 2; K5 as phase 3).  Beside K1's ms
    (CUDA events around 20 eager calls) its ms a call with 20 calls in one
    CUDA graph (graph_paired_ms, median of 10 replays), which has no host
    launch cost: the gap between the two is the host's."""
    from gpc_tpu_torch.ops.chol_pallas import chol_inv_block, chol_inv_block_plain
    from gpc_tpu_torch.ops.gram import dist_gram, dist_gram_plain
    from gpc_tpu_torch.ops.lazy_evidence import rbf_block_fn
    from gpc_tpu_torch.profile_slice import BENCH_HYP
    params = torch.tensor(BENCH_HYP[:2], dtype=torch.float32, device=dev)
    out = {}
    for tag, (i0, bi) in (("k1_tall", (512, N - 512)), ("k1_diag", (0, 512))):
        Xi, Xj = X[i0:i0 + bi], X[:512]
        got, want = dist_gram("rbf", params, Xi, Xj), dist_gram_plain("rbf", params, Xi, Xj)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"phase 24 {tag}: K1 off by {err}")
        ms, plain_ms = paired_ms(lambda: dist_gram("rbf", params, Xi, Xj),
                                 lambda: dist_gram_plain("rbf", params, Xi, Xj), 20)
        bound_ms, _ = k1_bound(bi, 512, Q)
        (graph_ms, _, _), (graph_plain_ms, _, _) = graph_paired_ms(
            lambda: dist_gram("rbf", params, Xi, Xj), lambda: dist_gram_plain("rbf", params, Xi, Xj))
        out[tag] = dict(shape=[bi, 512], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, graph_ms=graph_ms, graph_plain_ms=graph_plain_ms)
    A = rbf_block_fn(X, *BENCH_HYP)(0, 0, 512, 512)
    L, M = chol_inv_block(A)
    L_p, _ = chol_inv_block_plain(A)
    resid = float((M @ L - torch.eye(512, device=dev)).abs().max())
    err = float((L - L_p).abs().max())
    check(resid <= 1e-3 and err <= 1e-3 * float(L_p.abs().max()),
          f"phase 24 K5 n=512: max|M L - I| {resid}, L off by {err}")
    ms, plain_ms = paired_ms(lambda: chol_inv_block(A), lambda: chol_inv_block_plain(A), 20)
    out["k5_512"] = dict(max_abs_err=err, resid=resid, ms=ms, plain_ms=plain_ms,
                         bound_ms=k5_bound(512)[0])
    return out


def bench_grad(dev, X, m):
    """value_and_grad of evidence_flat under BENCH_GRAD_POLICY in (inverse
    width, variance, noise) against dense autograd (K1 Gram,
    torch.linalg.cholesky): θ̄ within BENCH_GRAD_TOL relative L2 and the
    value within BENCH_F32_TOL; for each, the peak GiB of one untimed call
    and the median and spread of 3 timed ones (host clock, synchronised)."""
    from gpc_tpu_torch.ops.evidence_fast import Policy, evidence_flat
    from gpc_tpu_torch.ops.lazy_evidence import rbf_block_fn
    from gpc_tpu_torch.profile_slice import BENCH_HYP

    def flat(h):
        return evidence_flat(rbf_block_fn(X, h[0], h[1], h[2]), N, m, Policy(*BENCH_GRAD_POLICY))

    def dense(h):
        L = torch.linalg.cholesky(rbf_block_fn(X, h[0], h[1], h[2])(0, 0, N, N))
        v = torch.linalg.solve_triangular(L, m, upper=False)
        return 2.0 * torch.sum(torch.log(torch.diagonal(L))), torch.sum(v * v)

    def value_and_grad(fn):
        h = torch.tensor(BENCH_HYP, dtype=torch.float32, device=dev, requires_grad=True)
        ld, quad = fn(h)
        obj = ld + quad
        return float(obj.detach()), torch.autograd.grad(obj, h)[0]

    out = {}
    for tag, fn in (("flat", flat), ("dense", dense)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (val, g), first_ms = timed(lambda: value_and_grad(fn))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = [timed(lambda: value_and_grad(fn))[1] for _ in range(3)]
        out[tag] = dict(value=val, grad=g.tolist(), ms=float(np.median(times)),
                        ms_min=min(times), ms_max=max(times), first_ms=first_ms, peak_gib=peak)
    g, gd = np.array(out["flat"]["grad"]), np.array(out["dense"]["grad"])
    out["rel_l2"] = rel_l2(g, gd)
    out["value_rel"] = rel_err(out["flat"]["value"], out["dense"]["value"])
    check(np.all(np.isfinite(g)) and out["rel_l2"] < BENCH_GRAD_TOL
          and out["value_rel"] < BENCH_F32_TOL,
          f"phase 24 evidence_flat value_and_grad vs dense: value rel {out['value_rel']}, "
          f"θ̄ rel L2 {out['rel_l2']}")
    return out


def phase_bench_evidence(dev):
    """Phase 24: gpc_tpu's bench evidence engines at its bench geometry,
    uncut (bench.py:33-40, 92-94: N = 16384, q = 8, D = 1, X and m ~ N(0, 1)
    from default_rng(0), rbf inverse width 1, variance 1, noise 0.1): each
    candidate of profile_slice.bench_candidates once untimed with the K1, K3
    and K5 launches counted around that call alone (each must launch the
    kernels it names), then 3 calls timed with CUDA events (median, spread),
    its peak GiB, and its (logdet, quad) against the dense f32 evidence
    (cholesky_ex) at N = 16384 and against the CPU float64 route on the
    first 2048 rows (the candidate run there on the card): within
    BENCH_F32_TOL for f32 engines, BENCH_BF16_TOL for bf16 ones.  Then K1
    and K5 at the phase's shapes against their plain versions, and one
    value_and_grad of evidence_flat against dense autograd.  Returns (the
    bench_evidence record, the phase's launches by kernel)."""
    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.profile_slice import K1, K3, K5, bench_candidates, bench_data
    from gpc_tpu_torch.utils.profiling import time_fn
    t0 = time.perf_counter()
    X, m = bench_data(N, Q, dev)
    Xs, m_s = X[:BENCH_CPU_ROWS].contiguous(), m[:BENCH_CPU_ROWS].contiguous()
    cands = bench_candidates()
    dense = {c[0]: c[1] for c in cands}["cholesky_ex"]
    ref64 = tuple(float(v) for v in dense(Xs.cpu().double(), m_s.cpu().double()))
    ref32 = tuple(float(v) for v in dense(X, m))
    rows, launches = [], collections.Counter()
    for name, fn, bf16, kernels in cands:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.LAUNCHES.clear()
        (ld, quad), first_ms = timed(lambda: fn(X, m))
        counts = {k: cuda_lib.LAUNCHES.get(k, 0) for k in (K1, K3, K5)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in kernels:
            check(counts[k] > 0, f"phase 24 {name}: kernel {k} was not launched")
        launches.update(counts)
        ld, quad = float(ld), float(quad)
        times = [time_fn(fn, X, m, reps=1, warmup=0) * 1e3 for _ in range(3)]
        ld_s, quad_s = (float(v) for v in fn(Xs, m_s))
        tol = BENCH_BF16_TOL if bf16 else BENCH_F32_TOL
        drift = max(rel_err(ld, ref32[0]), rel_err(quad, ref32[1]))
        drift64 = max(rel_err(ld_s, ref64[0]), rel_err(quad_s, ref64[1]))
        row = dict(name=name, bf16=bf16, ms=float(np.median(times)), ms_min=min(times),
                   ms_max=max(times), first_ms=first_ms, peak_gib=peak,
                   launches={k: v for k, v in counts.items() if v}, logdet=ld, quad=quad,
                   drift_dense_f32=drift, drift_cpu_f64_2048=drift64, limit=tol)
        log(f"phase 24 {name}: " + json.dumps(row))
        check(np.isfinite([ld, quad, ld_s, quad_s]).all() and drift < tol and drift64 < tol,
              f"phase 24 {name}: drift {drift} from the dense f32 evidence, {drift64} from "
              f"the CPU float64 route on {BENCH_CPU_ROWS} rows (limit {tol})")
        rows.append(row)
    kernels = bench_kernels(dev, X)
    grad = bench_grad(dev, X, m)
    record = dict(N=N, q=Q, D=1, dense_f32=dict(logdet=ref32[0], quad=ref32[1]),
                  cpu_f64_2048=dict(logdet=ref64[0], quad=ref64[1]), candidates=rows,
                  kernel_checks=kernels, grad=grad, wall_s=time.perf_counter() - t0)
    return record, dict(launches)


def main():
    card = require_card()   # exits non-zero without a CUDA device
    from gpc_tpu_torch.ops import cuda_lib
    dev = torch.device("cuda")
    log(card)
    rng = np.random.default_rng(SEED)

    t_start = time.perf_counter()
    phase_build(cuda_lib)
    k1 = phase_gram(dev, rng)
    k4, _ = phase_inner(dev, rng)
    torch.cuda.empty_cache()
    k2 = phase_leaf(dev, rng)
    k5, _ = phase_chol_inv(dev, rng)
    k6, _ = phase_chol_block(dev, rng)
    k3 = phase_panel(dev)
    k3d = phase_diag(dev)
    torch.cuda.empty_cache()
    drift = phase_panel_drift(dev)
    torch.cuda.empty_cache()
    phase_reference(dev)
    phase_grad_reference(dev)

    with tempfile.TemporaryDirectory() as workdir:
        cuda_lib.LAUNCHES.clear()
        phase_slice(dev, workdir)
        launches = dict(cuda_lib.LAUNCHES)
        log(f"inference-path launches: {launches}")
        for name in ("dist_gram", "factor_diag", "panel_state_rbf", "panel_corr"):
            check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the inference path")
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        train = phase_train_cli(dev, workdir)
        train_launches = dict(cuda_lib.LAUNCHES)
        log(f"training-path launches: {train_launches}")
        for name in ("dist_gram", "panel_leaf_diag", "panel_corr"):
            check(train_launches.get(name, 0) > 0, f"kernel {name} was not launched on the training path")
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        zoo = phase_zoo(dev, workdir)
        zoo_launches = dict(cuda_lib.LAUNCHES)
        log(f"kernel-zoo-path launches: {zoo_launches}")
        check(zoo_launches.get("inner_gram", 0) > 0, "kernel inner_gram was not launched "
                                                     "on the kernel-zoo path")
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        sparse = phase_sparse(dev, workdir)
        sparse_launches = dict(cuda_lib.LAUNCHES)
        log(f"sparse-path launches: {sparse_launches}")
        for name in ("dist_gram", "dist_gram_batched", "inner_gram"):
            check(sparse_launches.get(name, 0) > 0, f"kernel {name} was not launched on the "
                                                    "sparse path")
        log("sparse: " + json.dumps(sparse))
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        phase_ftc_optimisers(workdir)
        opt_launches = dict(cuda_lib.LAUNCHES)
        log(f"FTC optimiser-path launches: {opt_launches}")
        check(opt_launches.get("dist_gram", 0) > 0, "kernel dist_gram was not launched on the "
                                                   "FTC optimiser path")
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        ivm_select = phase_ivm_select(dev)
        ivm_cli = phase_ivm_cli(dev, workdir)
        ivm_launches = dict(cuda_lib.LAUNCHES)
        log(f"IVM-path launches: {ivm_launches}")
        for name in ("dist_gram", "inner_gram"):
            check(ivm_launches.get(name, 0) > 0, f"kernel {name} was not launched on the "
                                                 "IVM path")
        log("ivm: " + json.dumps(dict(selection=ivm_select, cli=ivm_cli)))
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        gplvm = phase_gplvm(dev)
        torch.cuda.empty_cache()
        gplvm_cli = phase_gplvm_cli(dev, workdir)
        gplvm_launches = dict(cuda_lib.LAUNCHES)
        log(f"GP-LVM-path launches: {gplvm_launches}")
        for name in ("dist_gram", "inner_gram", "chol_inv_block", "panel_leaf_diag",
                     "panel_corr"):
            check(gplvm_launches.get(name, 0) > 0, f"kernel {name} was not launched on the "
                                                   "GP-LVM path")
        log("gplvm: " + json.dumps(dict(model=gplvm, cli=gplvm_cli)))
        torch.cuda.empty_cache()

        cuda_lib.LAUNCHES.clear()
        interop = phase_interop(dev, workdir)
        interop_launches = dict(cuda_lib.LAUNCHES)
        log(f"interop-path launches: {interop_launches}")
        for name in ("dist_gram", "inner_gram"):
            check(interop_launches.get(name, 0) > 0, f"kernel {name} was not launched on the "
                                                     "interop path")
        log("interop: " + json.dumps(interop))
        torch.cuda.empty_cache()

        with world_one(dev, workdir) as mesh:
            cuda_lib.LAUNCHES.clear()
            distributed = phase_dist(dev, workdir, mesh)
            dist_launches = dict(cuda_lib.LAUNCHES)
            log(f"distributed-path launches: {dist_launches}")
            check(dist_launches.get("dist_gram", 0) > 0, "kernel dist_gram was not launched on "
                                                         "the distributed path")
            torch.cuda.empty_cache()

            DIST2_LAUNCHES.clear()
            t23 = time.perf_counter()
            dist2, ivm_model, ivm_order = phase_dist2(dev, workdir, mesh)
            dist2_launches = sum(DIST2_LAUNCHES.values(), collections.Counter())
            log(f"phase 23 (world 1) launches, the distributed calls' own: "
                f"{json.dumps(DIST2_LAUNCHES)}; in all {dict(dist2_launches)}")
            check_dist2_launches("phase 23 world 1", DIST2_MODULES, mlp=True)
        torch.cuda.empty_cache()
        gloo = gloo_two_ranks(workdir)
        log("phase 22 gloo, two ranks on one card: " + json.dumps(
            {k: v for k, v in gloo.items() if k in ("all_reduce", "all_gather", "broadcast")
             or k.startswith(("dtc_", "ftc_"))}))
        distributed["gloo_two_ranks"] = gloo
        dist2["gloo"] = {k: v for k, v in gloo.items() if k in ("dist_ftc", "ivm", "scaling")
                         or k.startswith("sparse2d_")}
        dist2["gloo"]["ivm"].update(ivm_order_check("dist_ivm gloo world 2", ivm_model,
                                                    gloo["ivm_order"], ivm_order))
        t1 = dist2["scaling"]["run"]["t_ms"]
        for line in (dist2["scaling"]["run"], gloo["scaling"]):
            log("phase 23(g) scaling_bench: " + json.dumps(
                dict(devices=line["devices"], n=line["n"], t_ms=line["t_ms"],
                     efficiency=t1 / line["t_ms"])))
        dist2["gloo"]["launches_rank0"] = gloo["dist2_launches"]
        log(f"phase 23(f) gloo, two ranks on one card: {json.dumps(dist2['gloo'])}")
        log(f"phase 23 wall {time.perf_counter() - t23:.1f} s")
        log("distributed: " + json.dumps(distributed))
        log("distributed, the rest: " + json.dumps(dist2))
        from gpc_tpu_torch.io.svml import READS
        log(f"SVM-light reads in this process: {dict(READS)}")
        check(READS["python"] == 0 and READS["native"] > 0,
              "the Python SVM-light reader ran: the native reader did not build or load")

    cuda_lib.LAUNCHES.clear()
    iterative = phase_iterative(dev)
    iter_launches = dict(cuda_lib.LAUNCHES)
    log(f"iterative-path launches: {iter_launches}")
    check(iter_launches.get("dist_gram", 0) > 0, "kernel dist_gram was not launched on the "
                                                 "iterative path")
    log("iterative: " + json.dumps(iterative))
    torch.cuda.empty_cache()
    gplvm_k, gplvm_panel = phase_gplvm_kernels(dev, rng)
    log("gplvm panel evidence: " + json.dumps(gplvm_panel))
    torch.cuda.empty_cache()
    sparse_k = phase_sparse_kernels(dev, rng)
    ivm_k = phase_ivm_kernels(dev, rng)
    torch.cuda.empty_cache()
    cuda_lib.LAUNCHES.clear()
    phase_k5_path(dev)
    k5_launches = dict(cuda_lib.LAUNCHES)
    log(f"K5-path launches: {k5_launches}")
    check(k5_launches.get("chol_inv_block", 0) > 0, "kernel chol_inv_block was not launched "
                                                    "on the K5 path")
    torch.cuda.empty_cache()
    timing = phase_train_timing(dev)
    log("training: " + json.dumps({e: dict(train[e], **timing[e]) for e in train}))
    torch.cuda.empty_cache()
    zoo_timing = phase_zoo_timing(dev)
    log("kernel zoo: " + json.dumps(dict(zoo, timing=zoo_timing)))
    torch.cuda.empty_cache()
    ragged_launches, ragged_ms = phase_k5_ragged_path(dev)
    k6_launches = phase_chol_block_path(dev)
    torch.cuda.empty_cache()
    mega_launches, k7, mega_modes = phase_mega(dev, k3["ms"])
    torch.cuda.empty_cache()
    probe_launches, k8, probes = phase_overlap(dev)
    torch.cuda.empty_cache()
    dot_launches, k8bc, dots = phase_dots(dev)
    torch.cuda.empty_cache()
    vpu_launches, k8d, vpu = phase_vpu(dev)
    torch.cuda.empty_cache()
    cuda_lib.LAUNCHES.clear()
    bench_evidence, bench_launches = phase_bench_evidence(dev)
    log(f"bench-evidence-path launches (phase 24, each candidate's own call): {bench_launches}")
    for name in ("dist_gram", "panel_state_rbf", "chol_inv_block"):
        check(bench_launches.get(name, 0) > 0, f"kernel {name} was not launched on the "
                                               "bench-evidence path")
    log("launches in the kernels line count wrapper calls; a K5 or K6 call launches several "
        "kernels (phase 3 prints how many); a K3 call is one walk of its plan, N/128 fills and "
        "leaves, N/128 - 1 solves, and corr_launches counts its wgmma correction launches")
    log("probes: " + json.dumps(dict(ragged_path_ms=ragged_ms, k7=mega_modes,
                                     k3_drift_n32768=drift,
                                     k3_ms=k3["ms"], **probes, k8bc=dots, k8d=vpu)))

    at_sparse = {name: dict(sparse_launches=sparse_launches[name], sparse_ms=r["ms"],
                            sparse_plain_ms=r["plain_ms"], sparse_bound_ms=r["bound_ms"],
                            sparse_max_abs_err=r["max_abs_err"])
                 for name, r in sparse_k.items() if name != "dist_gram_batched"}
    kernels = [
        dict(name="dist_gram", route="cuda", source="gpc_tpu_torch/csrc/gram.cu",
             replaces="gpc_tpu/ops/gram_pallas.py:89", launches=launches["dist_gram"], **k1,
             **at_sparse["dist_gram"], ftc_optimiser_launches=opt_launches["dist_gram"],
             ivm_launches=ivm_launches["dist_gram"], ivm_shapes=ivm_k["dist_gram"],
             gplvm_launches=gplvm_launches["dist_gram"],
             iterative_launches=iter_launches["dist_gram"], gplvm_shapes=gplvm_k,
             interop_launches=interop_launches["dist_gram"],
             fgp_launches=interop["fgp_launches"]["dist_gram"],
             dist_launches=dist_launches["dist_gram"],
             dist2_launches=dist2_launches["dist_gram"],
             bench_launches=bench_launches["dist_gram"]),
        dict(name="dist_gram_batched", route="cuda", source="gpc_tpu_torch/csrc/gram.cu",
             replaces="gpc_tpu/models/gp.py:132 (XLA's vmapped kern.gram, no pallas_call; "
                      "K1's batch axis)",
             launches=sparse_launches["dist_gram_batched"], library_ms=None,
             **sparse_k["dist_gram_batched"]),
        dict(name="factor_diag", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_panel.py:209", launches=launches["factor_diag"], **k2),
        dict(name="panel_state_rbf", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_panel.py:790",
             launches=launches["panel_state_rbf"], corr_launches=launches["panel_corr"],
             bench_launches=bench_launches["panel_state_rbf"], **k3),
        dict(name="panel_state_rbf_diag", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_panel.py:598",
             launches=train_launches["panel_leaf_diag"],
             corr_launches=train_launches["panel_corr"],
             gplvm_launches=gplvm_launches["panel_leaf_diag"],
             gplvm_corr_launches=gplvm_launches["panel_corr"], **k3d),
        dict(name="inner_gram", route="cuda", source="gpc_tpu_torch/csrc/gram.cu",
             replaces="gpc_tpu/ops/gram_pallas.py:145", launches=zoo_launches["inner_gram"], **k4,
             **at_sparse["inner_gram"], ivm_launches=ivm_launches["inner_gram"],
             gplvm_launches=gplvm_launches["inner_gram"],
             ivm_shapes=ivm_k["inner_gram"], interop_launches=interop_launches["inner_gram"],
             fgp_launches=interop["fgp_launches"]["inner_gram"],
             dist2_launches=dist2_launches["inner_gram"]),
        dict(name="chol_inv_block", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_pallas.py:185, gpc_tpu/ops/chol_pallas.py:213",
             launches=ragged_launches["chol_inv_block"],
             gplvm_launches=gplvm_launches["chol_inv_block"],
             bench_launches=bench_launches["chol_inv_block"], **k5),
        dict(name="chol_block", route="cuda", source="gpc_tpu_torch/csrc/chol_panel.cu",
             replaces="gpc_tpu/ops/chol_pallas.py:88", launches=k6_launches["chol_block"], **k6),
        dict(name="evidence_mega_rbf", route="cuda", source="gpc_tpu_torch/csrc/chol_mega.cu",
             replaces="tools/chol_mega_v2.py:218",
             launches=mega_launches["evidence_mega_rbf"], **k7),
        dict(name="overlap_probe", route="cuda", source="gpc_tpu_torch/csrc/probes.cu",
             replaces="tools/tpu_overlap_probe.py:109",
             launches=probe_launches["overlap_probe"], **k8["overlap_probe"]),
        dict(name="dma_probe", route="cuda", source="gpc_tpu_torch/csrc/probes.cu",
             replaces="tools/tpu_overlap_probe.py:158",
             launches=probe_launches["dma_probe"], **k8["dma_probe"]),
        dict(name="leaf_parts_probe", route="cuda", source="gpc_tpu_torch/csrc/probes.cu",
             replaces="tools/tpu_overlap_probe.py:237",
             launches=probe_launches["leaf_parts_probe"], **k8["leaf_parts_probe"]),
        dict(name="dotform_probe", route="cuda", source="gpc_tpu_torch/csrc/probes_dots.cu",
             replaces="tools/tpu_dotform_probe.py:88",
             launches=dot_launches["dotform_probe"], **k8bc["dotform_probe"]),
        dict(name="refread_probe", route="cuda", source="gpc_tpu_torch/csrc/probes_dots.cu",
             replaces="tools/tpu_refread_probe.py:111",
             launches=dot_launches["refread_probe"], **k8bc["refread_probe"]),
        *(dict(name=name, route="cuda", source="gpc_tpu_torch/csrc/probes_vpu.cu",
               replaces=f"tools/tpu_vpu_probe.py:{line}", launches=vpu_launches[name], **k8d[name])
          for name, line in (("vpu_exp", 114), ("vpu_gram_tile", 121), ("vpu_matvec", 128),
                             ("vpu_stage_store", 134))),
    ]
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"bench_evidence": bench_evidence}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
