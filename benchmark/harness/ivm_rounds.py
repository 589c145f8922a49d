"""Traffic kind `ivm_rounds`: a closed loop of `ivm learn` segments.

Each segment is the work of `ivm learn -o regression -k rbf -a d -# K -n S
-e E` once its data are loaded: IVM.optimise(ext_iters=E, kern_iters=K,
noise_iters=S), E times a selection pass and an SCG round over the kernel
parameters on the active-set likelihood, then a pass and an SCG round over
the noise parameters, and a last pass.  Every segment restarts from the
same θ₀: the kernel's and the noise model's parameters and the MT19937
state are restored; the model and its captured CUDA graph are kept.  Set-up
builds the model from the seed's data and runs one warm segment, so the
capture falls in set-up.  Segments run back to back until the deadline; the
one in progress when it falls is finished and counted.  A traced run
profiles the window's first segment and reads the program's counters at
the traced part's open and close (`run.counts`).

Correct: after the window the first segment and `sample` more, drawn from
the seed among the rest of the window's segments, are judged against the
plain float64 reference (reference/ivm.py) on the card:
  pick_gap   at every pass, the reference's replay along the program's
             order: the largest gap between a step's largest entropy score
             and the score of the point the program added, relative to the
             largest (float32 near-ties make most picks differ from the
             float64 maximum, so the orders are never compared);
  state_gap  at every pass, μ, ς and the site means and precisions against
             that replay, each relative to the field's largest reference
             entry (both inf where the order is not d distinct points);
  step_gap   the reference SCG (reference/scg.py) following every round
             step by step from the program's evaluations;
  obj_gap    |f − f_ref| per active point (kernel rounds) or per datum
             (noise rounds),
  grad_gap   the worst leaf's gap of gradient norms (judge.leaf_gap) in the
             kernel rounds, and
  noise_grad_gap  the same in the noise rounds, at every evaluation whose
             value and gradient SCG went on with: the initial point, the
             curvature probes, the accepted trial steps; the reference's
             objective is built on its own replay of the pass that preceded
             the round (in the noise rounds the gradient in the bias sums
             (y − μ − bias)/(ς + σ²) over the active points, where ς + σ²
             is about 2σ², so it carries μ's float32 rounding times 1/σ²);
  descent_gap  at a rejected trial step, how far per active point or datum
             the reference finds the objective below that of the point the
             step was tried from (0 where the reference, too, rejects).
A number is compared where the cell's limits name it.  `attempted` counts
the SCG iterations of the window, `failed` its rounds whose objective is
not finite."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import data, judge
from harness.spans import Tracer
from harness.spec import module

STATE_FIELDS = ("mu", "varsigma", "m_site", "beta_site")


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_proc: float,
        run_record) -> judge.Outcome:
    cfg, tr = cell.config, cell.traffic
    system = cell.system()
    system.configure(cfg)
    X, y = data.regression(seed, cfg["N"], cfg["q"], cfg["D"], cfg["noise"])
    model = system.model(cfg, X, y, int(tr["cli_seed"]), device)
    theta0 = system.start(model)
    tracer = Tracer(trace)

    counts = module(cell.root, "systems", "gp_counts").counts
    system.restore(model, theta0, None)
    if system.optimise(model, tr) is None:      # warm-up: one segment, the graph's capture
        raise RuntimeError("ivm_rounds: IVM.optimise returned no rounds; this traffic kind "
                           "counts SCG iterations from the (kind, result) list it returns")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    tracer.warm()
    run = run_record
    run.setup_s = time.perf_counter() - t_proc

    kept, sample = [], int(tr["sample"])
    g = data.rng(seed, data.SAMPLE)
    n_seen = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    iters = failed = 0
    while True:
        first = not run.segments
        log = {"passes": [], "rounds": []}
        system.restore(model, theta0, log)
        if first:
            tracer.start()
            c0 = counts()
        s0 = time.perf_counter()
        rounds = system.optimise(model, tr)
        s1 = time.perf_counter()
        if first:
            tracer.stop()
            run.counts = (c0, counts())
        for r, (kind, res) in zip(log["rounds"], rounds):
            r.update(kind=kind, x=np.asarray(res.x, dtype=np.float64), obj=float(res.obj),
                     iters=int(res.iters))
        seg_iters = sum(int(res.iters) for _, res in rounds)
        iters += seg_iters
        failed += sum(not np.isfinite(float(res.obj)) for _, res in rounds)
        evals = [e for r in log["rounds"] for e in r["evals"]]
        kinds = [r["kind"] for r in log["rounds"] for _ in r["evals"]]
        run.segments.append((s0, s1, seg_iters, len(evals), len(log["passes"]),
                             kinds.count("kern"), kinds.count("noise")))
        run.evals.extend((e[3], e[4]) for e in evals)
        # the first segment, and a uniform draw of `sample` among the rest
        if first:
            kept.append(log)
        else:
            n_seen += 1
            if len(kept) <= sample:
                kept.append(log)
            else:
                j = int(g.integers(n_seen))
                if j < sample:
                    kept[1 + j] = log
        if s1 >= deadline:
            break
    run.window_s = time.perf_counter() - t_start
    if torch.device(device).type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.trace = tracer.read()
    del model
    gc.collect()

    checks = _check(cell, X, y, kept, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return judge.Outcome(run=run, attempted=iters, failed=failed, checks=checks)


def state_gap(st: dict, ref_st: dict) -> float:
    """The largest of μ, ς and the site means and precisions against the
    reference's, each over that field's largest reference entry."""
    out = 0.0
    for f in STATE_FIELDS:
        a = torch.as_tensor(st[f]).to(torch.float64).cpu()
        b = torch.as_tensor(ref_st[f]).to(torch.float64).cpu()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            return np.inf
        scale = float(b.abs().max())
        out = max(out, float((a - b).abs().max()) / scale if scale > 0 else float(a.abs().max()))
    return out


def _check(cell, X, y, kept: list, device: str) -> dict:
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    scg = module(cell.root, "reference", "scg")
    n_iters = {"kern": int(tr["kern_iters"]), "noise": int(tr["noise_iters"])}
    per = {"kern": float(cfg["d"]), "noise": float(cfg["N"] * cfg["D"])}
    leaves = {"kern": ref.kern_leaves(cfg), "noise": ref.noise_leaves(cfg)}
    grad = {"kern": "grad_gap", "noise": "noise_grad_gap"}
    out = dict(pick_gap=0.0, state_gap=0.0, step_gap=0.0, obj_gap=0.0, grad_gap=0.0,
               noise_grad_gap=0.0, descent_gap=0.0)
    for k, log in enumerate(kept):
        replays = []
        for p in log["passes"]:
            order = torch.as_tensor(p["state"]["active_idx"]).cpu().numpy()
            rs, gaps = ref.replay(cfg, X, y, p["kp"], p["np"], order, device)
            if len(gaps) == len(order) == int(cfg["d"]):
                out["pick_gap"] = max(out["pick_gap"], float(gaps.max()))
                out["state_gap"] = max(out["state_gap"], state_gap(p["state"], rs))
            else:       # not d distinct points: the replay stopped where it broke
                out["pick_gap"] = out["state_gap"] = np.inf
            replays.append((order, rs))
        for r in log["rounds"]:
            kind, evals = r["kind"], r["evals"]
            order, rs = replays[r["pass"]]
            p = log["passes"][r["pass"]]
            a0 = ref.kern_a(p["kp"]) if kind == "kern" else ref.noise_a(p["np"])
            roles = {}
            out["step_gap"] = max(out["step_gap"], scg.replay(
                [e[:3] for e in evals], a0, n_iters[kind], result_w=r["x"], roles=roles))
            for i, (w, f, gr, _, _) in enumerate(evals):
                role, old = roles.get(i, (None, None))
                if kind == "kern":
                    f_ref, g_ref = ref.active_nll_and_grad(cfg, X[order], rs["m_site"],
                                                           rs["beta_site"], w, device)
                else:
                    f_ref, g_ref = ref.noise_nll_and_grad(cfg, y, rs["mu"], rs["varsigma"],
                                                          w, device)
                if role == "rejected":
                    if f_ref < old:
                        out["descent_gap"] = max(out["descent_gap"], (old - f_ref) / per[kind])
                elif role is not None and np.isfinite(f) and np.isfinite(gr).all():
                    out["obj_gap"] = max(out["obj_gap"], abs(f - f_ref) / per[kind])
                    out[grad[kind]] = max(out[grad[kind]], judge.leaf_gap(gr, g_ref, leaves[kind]))
                else:
                    out["obj_gap"] = out[grad[kind]] = np.inf
        print(f"ivm_rounds: segment {k}: {len(log['passes'])} passes, "
              f"{sum(len(r['evals']) for r in log['rounds'])} evaluations judged; "
              + ", ".join(f"{n} {v!r}" for n, v in out.items()), file=sys.stderr)
    return out
