"""Weak scaling of the distributed evidence, and its collective census
(counterpart of gpc_tpu/parallel/scaling_bench.py).

gpc_tpu reads its census from XLA's optimized HLO and runs every device
count in one process.  The port runs one process a rank, so:

  * the census is measured: every collective of the distributed layer
    counts its calls and output bytes in parallel.mesh.COLLECTIVES, and
    `collective_stats(fn, *args)` returns what one call of fn ran;
  * `weak_scaling_artifact` reports the census of one dist_ftc
    value_and_grad and of the iterative proxy beside gpc_tpu's analytic
    bytes (one (N, B) panel all-gather a panel step);
  * `run()` times the DTC value_and_grad of the current world at
    rows_per_device · world rows;
  * `python -m gpc_tpu_torch.parallel.scaling_bench` starts each world
    size as child processes joined through a file:// store (NCCL with one
    rank a card, gloo on the CPU) and prints gpc_tpu's line
    {devices, n, t_ms, efficiency} for each world.

    python -m gpc_tpu_torch.parallel.scaling_bench [rows_per_device] [num_active] \\
        [--device cpu] [--worlds 1,2]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gpc_tpu_torch import kernels as K
from gpc_tpu_torch import resolve_device
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.optim import numpy_value_and_grad
from gpc_tpu_torch.parallel import mesh as mesh_mod
from gpc_tpu_torch.parallel.dist_gp import make_dist_objective
from gpc_tpu_torch.parallel.mesh import data_mesh, pad_rows, shard_rows


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _kern(q):
    return K.Cmpnd(input_dim=q, components=(K.Rbf(input_dim=q), K.Bias(input_dim=q),
                                            K.White(input_dim=q)))


def collective_stats(fn, *args):
    """{op: {"count", "bytes"}}: the collectives one call fn(*args) ran, by
    op ("all-gather", "all-reduce", "broadcast"), with the bytes of their
    outputs summed (gpc_tpu's return shape; it reads a static HLO census
    where the port counts the calls)."""
    before = copy.deepcopy(dict(mesh_mod.COLLECTIVES))
    fn(*args)
    census = {}
    for op, ent in mesh_mod.COLLECTIVES.items():
        was = before.get(op, {"count": 0, "bytes": 0})
        if ent["count"] > was["count"]:
            census[op] = {"count": ent["count"] - was["count"],
                          "bytes": ent["bytes"] - was["bytes"]}
    return census


def weak_scaling_artifact(n_devices: int, rows_per_device: int = 128, q: int = 4,
                          mesh=None) -> dict:
    """The weak-scaling record of the current world (n_devices must be its
    size): the measured census of one dist_ftc value_and_grad at
    N = rows_per_device · n_devices beside gpc_tpu's analytic model (one
    (N, B) panel all-gather a panel step, N² numbers a forward; the
    backward's sweeps add the rest), and of the iterative proxy."""
    from gpc_tpu_torch.parallel.dist_ftc import make_dist_ftc_value_and_grad

    mesh = data_mesh() if mesh is None else mesh
    if mesh.size != n_devices:
        raise ValueError(f"weak_scaling_artifact: n_devices {n_devices}, world {mesh.size}")
    N = rows_per_device * n_devices
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, q))
    y = np.sin(X[:, :1])
    model = GP(_kern(q), X, y, approx="ftc", centre=True, device=mesh.device)
    Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, np.ones(N)))
    nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, N)
    vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
    census = collective_stats(vag, model.theta)
    dtype_bytes = torch.finfo(Xl.dtype).bits // 8
    return {
        "weak_scaling_proxy": {
            "n_devices": n_devices,
            "n": N,
            "rows_per_device": rows_per_device,
            "program": "dist_ftc value+grad (chol_distributed panel sweeps)",
            "collectives_measured": census,
            "panel_trip_count": n_devices,
            "analytic_allgather_elems_per_forward": N * N,
            "analytic_bytes_per_forward": N * N * dtype_bytes,
            "analytic_bytes_per_value_and_grad": 3 * N * N * dtype_bytes,
            "note": ("measured counts are calls this run made: the forward gathers "
                     "each panel once, the backward twice (one forward sweep of "
                     "this rank's unit columns, one backward sweep of [v | L^-1 E]), "
                     "so the panel all-gathers are 3 x n_devices of N x B, "
                     "beside the X, mask and m gathers; gpc_tpu's analytic model "
                     "counts 4 N^2 a value_and_grad (three backward sweeps)"),
        },
        "iterative_weak_scaling_proxy": _iterative_proxy(mesh, rows_per_device, q, model,
                                                         Xl, yl, ml),
    }


def _iterative_proxy(mesh, rows_per_device, q, model, Xl, yl, ml):
    """The census of a dist_iterative value_and_grad: one (N/P, D')
    all-gather a MVM (cg iterations + Lanczos steps), a few scalars."""
    from gpc_tpu_torch.ops.iterative import IterConfig
    from gpc_tpu_torch.parallel.dist_iterative import dist_iterative_nlml

    N = rows_per_device * mesh.size
    cfg = IterConfig(block=max(rows_per_device // 2, 16), probes=2, lanczos_iters=8,
                     cg_iters=20, trace_probes=2, seed=0)
    nlml = dist_iterative_nlml(model.spec.kern, mesh, model.bias, model.fixed_scales, N, cfg)
    vag = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)
    census = collective_stats(vag, model.theta)
    return {
        "program": "dist_iterative value+grad (row-sharded CG+SLQ)",
        "collectives_measured": census,
        "mvm_allgather_elems": N,
        "note": ("one (N/P, D') all-gather a MVM; cg_iters + lanczos_iters MVMs an "
                 "evidence (CG leaves early at its tolerance)"),
    }


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(rows_per_device: int = 2048, num_active: int = 256, q: int = 8, mesh=None,
        reps: int = 5) -> dict:
    """{devices, n, t_ms, census}: the mean ms of `reps` DTC value_and_grad
    calls (after a warm-up) of the current world at N = rows_per_device ·
    world, the data gpc_tpu's run() draws, and the collective census of
    one call."""
    mesh = data_mesh() if mesh is None else mesh
    nd = mesh.size
    N = rows_per_device * nd
    X = np.random.default_rng(0).standard_normal((N, q))
    y = np.sin(X[:, :1])
    model = GP(_kern(q), X, y, approx="dtc", num_active=num_active, centre=True, seed=0,
               device=mesh.device)
    Xp, _ = pad_rows(X, nd)
    yp, _ = pad_rows(y, nd)
    mask = np.ones(Xp.shape[0])
    Xl, yl, ml = (shard_rows(mesh, a) for a in (Xp, yp, mask))
    nlml = make_dist_objective(model.spec, mesh, model.bias, model.fixed_scales, N)
    theta = torch.as_tensor(model.theta, dtype=Xl.dtype, device=mesh.device)

    def vag():
        t = theta.clone().requires_grad_(True)
        f = nlml(t, Xl, yl, ml)
        (g,) = torch.autograd.grad(f, t)
        return f, g

    census = collective_stats(vag)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        f, g = vag()
    _sync(mesh.device)
    return dict(devices=nd, n=N, t_ms=(time.perf_counter() - t0) / reps * 1e3, census=census)


def _rank_main(args):
    """One rank of one world: joins the store's group, prints run()'s line
    (rank 0)."""
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = mesh_mod.backend_for(device)
    dist.init_process_group(backend, init_method=f"file://{args.store}",
                            world_size=args.world, rank=args.rank)
    try:
        res = run(args.rows_per_device, args.num_active, mesh=data_mesh(device))
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        print(json.dumps(dict(res, backend=backend)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows_per_device", nargs="?", type=int, default=2048)
    ap.add_argument("num_active", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--worlds", default=None,
                    help="world sizes, comma-separated (default: 1, 2, 4, ... up to the "
                         "cards; 1,2 on the CPU)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    device = resolve_device(args.device)
    if args.worlds:
        worlds = [int(w) for w in args.worlds.split(",")]
    elif device.type == "cuda":
        worlds = [w for w in (1, 2, 4, 8, 16, 32) if w <= torch.cuda.device_count()]
    else:
        worlds = [1, 2]
    results = []
    t1 = None
    for world in worlds:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
            procs = []
            for rank in range(world):
                cmd = [sys.executable, "-m", "gpc_tpu_torch.parallel.scaling_bench",
                       str(args.rows_per_device), str(args.num_active), "--device",
                       args.device, "--rank", str(rank), "--world", str(world),
                       "--store", os.path.join(tmp, "store")]
                procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
            outs = []
            try:
                for p in procs:
                    out, err = p.communicate(timeout=1800)
                    if p.returncode:
                        raise RuntimeError(f"scaling_bench: a rank of world {world} failed:\n"
                                           f"{err[-3000:]}")
                    outs.append(out)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        res = json.loads(outs[0].strip().splitlines()[-1])
        t1 = res["t_ms"] if t1 is None else t1
        line = dict(devices=res["devices"], n=res["n"], t_ms=res["t_ms"],
                    efficiency=t1 / res["t_ms"])
        results.append(dict(line, backend=res["backend"], census=res["census"]))
        print(json.dumps(line), flush=True)
    return results


if __name__ == "__main__":
    main()
