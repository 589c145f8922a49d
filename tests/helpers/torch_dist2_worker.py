"""One rank of the tests of the port's panel Cholesky, dist_ftc,
dist_gplvm, dist_iterative, dist_ivm, dist_sparse2d and scaling_bench
(tests/test_torch_chol_distributed.py ... test_torch_scaling_bench.py), and
of the dryruns and collective_stats (tests/test_torch_surface.py).

    GPC_TPU_COORDINATOR=file:///tmp/store GPC_TPU_NUM_PROCS=3 GPC_TPU_PROC_ID=0 \\
        python tests/helpers/torch_dist2_worker.py CASE IN.npz OUT.npz [N_MP N_DP]

Joins the gloo group through parallel.multihost.initialize_from_env, runs
CASE on the CPU in float64 on the inputs of IN.npz and writes this rank's
results to OUT.npz.  `spawn_worlds` runs every rank of each world size as
a process of its own (a file:// store under the test's tmp path, no TCP
port) and returns their outputs.  Imports neither jax nor gpc_tpu."""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpc_tpu_torch import kernels as KM  # noqa: E402
from gpc_tpu_torch import noise as NZ  # noqa: E402
from gpc_tpu_torch.models.gp import GP  # noqa: E402
from gpc_tpu_torch.models.gplvm import GPLVM  # noqa: E402
from gpc_tpu_torch.models.ivm import IvmSpec, active_log_likelihood  # noqa: E402
from gpc_tpu_torch.ops.iterative import IterConfig  # noqa: E402
from gpc_tpu_torch.optim import numpy_value_and_grad, scg  # noqa: E402
from gpc_tpu_torch.parallel import multihost  # noqa: E402
from gpc_tpu_torch.parallel.mesh import data_mesh, mesh_2d, pad_rows, shard_rows  # noqa: E402

WORKER = os.path.abspath(__file__)
WAIT_S = 240


def spawn_worlds(case, inputs, worlds, tmp_path_factory, grid=None):
    """{world: [rank 0's outputs, rank 1's, ...]} of CASE on `inputs` (a
    dict of numpy arrays); `grid` maps a world to its (n_mp, n_dp)."""
    out = {}
    for world in worlds:
        d = tmp_path_factory.mktemp(f"{case}_world{world}".replace(",", "x"))
        np.savez(d / "in.npz", **inputs)
        n = world if grid is None else grid[world][0] * grid[world][1]
        extra = [] if grid is None else [str(g) for g in grid[world]]
        procs = []
        for rank in range(n):
            env = dict(os.environ, GPC_TPU_COORDINATOR=f"file://{d / 'store'}",
                       GPC_TPU_NUM_PROCS=str(n), GPC_TPU_PROC_ID=str(rank),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, case, str(d / "in.npz"), str(d / f"out{rank}.npz")]
                + extra, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            for p in procs:
                _, err = p.communicate(timeout=WAIT_S)
                assert p.returncode == 0, f"{case} worker failed:\n{err[-3000:]}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        out[world] = [dict(np.load(d / f"out{r}.npz")) for r in range(n)]
    return out


def cmpnd(q, lead="rbf", white=True):
    parts = [KM.make_kern(lead, q), KM.Bias(input_dim=q)]
    return KM.Cmpnd(input_dim=q, components=tuple(parts + ([KM.White(input_dim=q)]
                                                           if white else [])))


def _grad(f, t):
    t = torch.as_tensor(t, dtype=torch.float64).clone().requires_grad_(True)
    v = f(t)
    (g,) = torch.autograd.grad(v, t)
    return float(v), g.numpy()


# -- cases ------------------------------------------------------------------

def case_chol(mesh, a):
    """chol_distributed of K; evidence_distributed of (K, m) with its K̄ and
    m̄ for 3·logdet + ½·quad; the same objective of θ through K(θ)'s rows."""
    from gpc_tpu_torch.linalg import dist2
    from gpc_tpu_torch.parallel.chol_distributed import chol_distributed, evidence_distributed
    from gpc_tpu_torch.parallel.dist_gp import share

    K, m, X = (torch.as_tensor(a[k]) for k in ("K", "m", "X"))
    N = K.shape[0]
    B = N // mesh.size
    lo, hi = mesh.rank * B, (mesh.rank + 1) * B
    out = {"L_rows": chol_distributed(mesh, K[lo:hi].contiguous()).numpy()}
    K_rows = K[lo:hi].clone().requires_grad_(True)
    mm = m.clone().requires_grad_(True)
    ld, quad = evidence_distributed(mesh, K_rows, mm)
    Kbar, mbar = torch.autograd.grad(3.0 * ld + 0.5 * quad, (K_rows, mm))
    out.update(logdet=float(ld), quad=float(quad), Kbar_rows=Kbar.numpy(), mbar=mbar.numpy())

    def obj(theta):
        iw, var, noise = share(theta, mesh)
        eye = torch.eye(N, dtype=X.dtype)[lo:hi]
        rows = var * torch.exp(-0.5 * iw * dist2(X[lo:hi], X)) + noise * eye
        ld, quad = evidence_distributed(mesh, rows, m)
        return 3.0 * ld + 0.5 * quad
    out["theta_f"], out["theta_g"] = _grad(obj, a["theta"])
    return out


def case_ftc(mesh, a):
    """make_dist_ftc_value_and_grad (fixed and learned scales), 5 SCG
    iterations, make_dist_ftc_posterior of Xq."""
    from gpc_tpu_torch.parallel.dist_ftc import (make_dist_ftc_posterior,
                                                 make_dist_ftc_value_and_grad)
    X, y, Xq = a["X"], a["y"], a["Xq"]
    N = X.shape[0]
    Xp, _ = pad_rows(X, mesh.size)
    yp, _ = pad_rows(y, mesh.size)
    mask = np.zeros(Xp.shape[0])
    mask[:N] = 1.0
    Xl, yl, ml = (shard_rows(mesh, v) for v in (Xp, yp, mask))
    out = {}
    for learn in (0, 1):
        model = GP(cmpnd(X.shape[1]), X, y, centre=True, learn_scales=bool(learn),
                   scale_data=bool(learn), device="cpu")
        nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, N)
        out[f"f{learn}"], out[f"g{learn}"] = _grad(lambda t: nlml(t, Xl, yl, ml), model.theta)
    model = GP(cmpnd(X.shape[1]), X, y, centre=True, device="cpu")
    nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, N)
    res = scg(numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device), model.theta,
              max_iters=5)
    out.update(scg_x=res.x, scg_obj=res.obj, scg_iters=res.iters)
    post = make_dist_ftc_posterior(model.spec, mesh, model.bias, model.fixed_scales, N)
    mu, var = post(torch.as_tensor(model.theta), Xl, yl, ml, torch.as_tensor(Xq))
    out.update(mu=mu.numpy(), var=var.numpy())
    return out


GPLVM_CASES = ("plain", "dynamics", "fixed_snr", "back", "back_dynamics")


def gplvm_model(case, y, bK=None):
    """The port GPLVM of each case of tests/test_dist_gplvm.py (θ set by the
    caller)."""
    q = 2
    dyn = KM.Cmpnd(input_dim=q, components=(KM.Rbf(input_dim=q), KM.White(input_dim=q)))
    kw = {"plain": {}, "dynamics": dict(dyn_kern=dyn, dyn_breaks=(0, 24)),
          "fixed_snr": dict(dyn_kern=dyn, dyn_kern_learnt=False,
                            dyn_kern_params=np.array([1.0, 0.25, 0.01]),
                            dynamic_scaling=True),
          "back": dict(back_kernel_matrix=bK),
          "back_dynamics": dict(back_kernel_matrix=bK, dyn_kern=dyn)}[case]
    return GPLVM(cmpnd(q), y, latent_dim=q, init="rand", device="cpu", **kw)


def case_gplvm(mesh, a):
    from gpc_tpu_torch.parallel.dist_gplvm import make_dist_gplvm_value_and_grad
    out = {}
    for case in GPLVM_CASES:
        y, bK = a[f"{case}_y"], a.get(f"{case}_bK")
        model = gplvm_model(case, y, bK)
        model.theta = a[f"{case}_theta"]
        model.noise_bias, model.fixed_scales = a[f"{case}_bias"], a[f"{case}_scales"]
        vag = make_dist_gplvm_value_and_grad(model.spec, mesh, model.noise_bias,
                                             model.fixed_scales, model.dyn_params_fixed)
        args = [shard_rows(mesh, y)] + ([shard_rows(mesh, bK)] if bK is not None else [])
        out[f"{case}_f"], out[f"{case}_g"] = _grad(lambda t: vag(t, *args), model.theta)
    return out


def iter_cfg(a, key):
    return IterConfig(*(int(v) for v in a[key]))


def case_iterative(mesh, a):
    """make_dist_iterative_evidence with gpc_tpu's probes, with the port's,
    on ragged N, preconditioned; dist_iterative_nlml and 5 SCG steps."""
    from gpc_tpu_torch.parallel.dist_iterative import (dist_iterative_nlml,
                                                       make_dist_iterative_evidence)
    kern = cmpnd(2)
    out = {}

    def evidence(tag, X, m, p, cfg, probes=None):
        Xp, _ = pad_rows(X, mesh.size)
        mp, _ = pad_rows(m, mesh.size)
        mask = np.zeros(Xp.shape[0])
        mask[:X.shape[0]] = 1.0
        Xl, ml, kl = (shard_rows(mesh, v).requires_grad_(v is not mask)
                      for v in (Xp, mp, mask))
        pt = torch.as_tensor(p).clone().requires_grad_(True)
        ev = make_dist_iterative_evidence(kern, mesh, cfg)
        ld, quad = ev(pt, Xl, ml, kl, probes)
        gp, gX, gm = torch.autograd.grad(ld + quad, (pt, Xl, ml))
        out.update({f"{tag}_ld": float(ld), f"{tag}_quad": float(quad), f"{tag}_gp": gp.numpy(),
                    f"{tag}_gX": gX.numpy(), f"{tag}_gm": gm.numpy()})

    cfg = iter_cfg(a, "cfg")
    evidence("jax", a["X"], a["m"], a["p"], cfg, (a["Ztr"], a["Zslq"]))
    evidence("own", a["X"], a["m"], a["p"], cfg)
    evidence("ragged", a["Xr"], a["mr"], a["p"], cfg)
    evidence("pre", a["X"], a["m"], a["p_hard"], iter_cfg(a, "cfg_pre"))
    evidence("plain25", a["X"], a["m"], a["p_hard"], iter_cfg(a, "cfg_plain25"))
    X, y = a["Xs"], a["ys"]
    N = X.shape[0]
    model = GP(kern, X, y, centre=True, device="cpu")
    Xl, yl, ml = (shard_rows(mesh, v) for v in (X, y, np.ones(N)))
    nlml = dist_iterative_nlml(kern, mesh, model.bias, model.fixed_scales, N, cfg)
    vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
    out["nlml_f"], out["nlml_g"] = vag(model.theta)
    res = scg(vag, model.theta, max_iters=5)
    out.update(scg_x=res.x, scg_obj=res.obj, scg_iters=res.iters)
    return out


def ivm_spec(noise_kind, N, d, selection):
    noise = NZ.ProbitNoise(output_dim=1) if noise_kind == "probit" else NZ.GaussianNoise(
        output_dim=1)
    return IvmSpec(kern=cmpnd(2), noise=noise, n_data=N, input_dim=2, output_dim=1,
                   num_active=d, selection=selection)


def case_ivm(mesh, a):
    """make_select_points_dist for each case of IN (its noise, selection,
    data, parameters and draws; ragged N padded with valid = 0 rows) and
    the active-set likelihood of its selection."""
    from gpc_tpu_torch.parallel.dist_ivm import make_select_points_dist
    out = {}
    for tag in [str(t) for t in a["tags"]]:
        X, y = a[f"{tag}_X"], a[f"{tag}_y"]
        N, d = X.shape[0], int(a[f"{tag}_d"])
        spec = ivm_spec(str(a[f"{tag}_noise"]), N, d, str(a[f"{tag}_selection"]))
        Xp, _ = pad_rows(X, mesh.size)
        yp, _ = pad_rows(y, mesh.size)
        valid = np.zeros(Xp.shape[0])
        valid[:N] = 1.0
        sel = make_select_points_dist(spec, mesh)
        st = sel(a[f"{tag}_kp"], a[f"{tag}_np"], *(shard_rows(mesh, v) for v in (Xp, yp, valid)),
                 a[f"{tag}_rand"])
        out.update({f"{tag}_{k}": getattr(st, k).numpy() for k in
                    ("active_idx", "active_mask", "m_site", "beta_site", "mu", "varsigma")})
        idx = st.active_idx.numpy()
        out[f"{tag}_ll"] = float(active_log_likelihood(
            spec, torch.as_tensor(a[f"{tag}_kp"]), torch.as_tensor(X[idx]), st.m_site,
            st.beta_site))
    return out


def case_sparse2d(mesh2, a):
    """make_dist2d_objective's value and θ̄ for DTC, DTCVAR, FITC, and 5 SCG
    iterations of each."""
    from gpc_tpu_torch.parallel.dist_sparse2d import make_dist2d_objective, shard_data_2d
    X, y = a["X"], a["y"]
    N, M = X.shape[0], int(a["M"])
    n_dp = mesh2.dp.size
    Xp, _ = pad_rows(X, n_dp)
    yp, _ = pad_rows(y, n_dp)
    mask = np.zeros(Xp.shape[0])
    mask[:N] = 1.0
    Xl, yl, ml = (shard_data_2d(mesh2, v) for v in (Xp, yp, mask))
    out = {}
    for approx in ("dtc", "dtcvar", "fitc"):
        model = GP(cmpnd(X.shape[1]), X, y, approx=approx, num_active=M, beta=2.0, seed=7,
                   device="cpu")
        nlml = make_dist2d_objective(model.spec, mesh2, model.bias, model.fixed_scales, N)
        vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh2.device)
        out[f"{approx}_theta"] = model.theta
        out[f"{approx}_f"], out[f"{approx}_g"] = vag(model.theta)
        res = scg(vag, model.theta, max_iters=5)
        out.update({f"{approx}_scg_x": res.x, f"{approx}_scg_obj": res.obj,
                    f"{approx}_scg_iters": res.iters})
    return out


def case_scaling(mesh, a):
    """weak_scaling_artifact's record and run()'s line of this world."""
    import json

    from gpc_tpu_torch.parallel import scaling_bench as sb
    rec = sb.weak_scaling_artifact(mesh.size, rows_per_device=int(a["rows"]), q=4, mesh=mesh)
    line = sb.run(rows_per_device=int(a["run_rows"]), num_active=int(a["run_m"]), q=3,
                  mesh=mesh, reps=1)
    return {"artifact": json.dumps(rec), "run": json.dumps(line)}


def case_dryrun(mesh, a):
    """dist_gplvm.dryrun and dist_ivm.dryrun on this world (their printed
    lines), and collective_stats of one all_reduce_sum and one gather_rows."""
    import contextlib
    import io
    import json

    from gpc_tpu_torch.parallel import dist_gplvm, dist_ivm
    from gpc_tpu_torch.parallel.mesh import all_reduce_sum, gather_rows
    from gpc_tpu_torch.parallel.scaling_bench import collective_stats

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dist_gplvm.dryrun(mesh, mesh.size)
        dist_ivm.dryrun(mesh, mesh.size)
    x = torch.ones((2, 3), dtype=torch.float64)
    stats = collective_stats(lambda: (all_reduce_sum(mesh, x), gather_rows(mesh, x)))
    return {"lines": buf.getvalue(), "stats": json.dumps(stats)}


CASES = dict(chol=case_chol, ftc=case_ftc, gplvm=case_gplvm, iterative=case_iterative,
             ivm=case_ivm, sparse2d=case_sparse2d, scaling=case_scaling, dryrun=case_dryrun)


def main(case, in_path, out_path, *grid):
    torch.set_num_threads(1)
    world = int(os.environ["GPC_TPU_NUM_PROCS"])
    assert multihost.initialize_from_env(device="cpu") == (world > 1)
    mesh = mesh_2d(int(grid[0]), int(grid[1]), "cpu") if grid else data_mesh("cpu")
    a = dict(np.load(in_path))
    out = CASES[case](mesh, a)
    np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
