"""One rank of the port's distributed tests (tests/test_torch_parallel.py).

    GPC_TPU_COORDINATOR=file:///tmp/store GPC_TPU_NUM_PROCS=3 GPC_TPU_PROC_ID=0 \\
        python tests/helpers/torch_dist_worker.py DATA.npz DATA.svml OUT.npz

Joins the gloo group through parallel.multihost.initialize_from_env, then
writes to OUT.npz: the distributed objective and gradient for each
approximation, 5 SCG iterations of make_dist_train_step (DTC and FTC), this
rank's block of load_svml_sharded, and GPServer(mesh=) predictions.
Imports neither jax nor gpc_tpu."""

import os
import sys

import numpy as np
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpc_tpu_torch import kernels as KM  # noqa: E402
from gpc_tpu_torch.models.gp import GP  # noqa: E402
from gpc_tpu_torch.optim import numpy_value_and_grad  # noqa: E402
from gpc_tpu_torch.parallel import multihost  # noqa: E402
from gpc_tpu_torch.parallel.dist_gp import (make_dist_objective,  # noqa: E402
                                            make_dist_train_step)
from gpc_tpu_torch.parallel.mesh import data_mesh, pad_rows, shard_rows  # noqa: E402
from gpc_tpu_torch.serving import GPServer  # noqa: E402

APPROXES = ("ftc", "dtc", "dtcvar", "fitc")


def model(approx, X, y):
    q = X.shape[1]
    kern = KM.Cmpnd(input_dim=q, components=(KM.Rbf(input_dim=q), KM.Bias(input_dim=q),
                                             KM.White(input_dim=q)))
    kw = dict(num_active=9, beta=2.0, seed=5) if approx != "ftc" else {}
    return GP(kern, X, y, approx=approx, centre=True, device="cpu", **kw)


def main(data_path, svml_path, out_path):
    assert multihost.initialize_from_env(device="cpu") == (int(os.environ["GPC_TPU_NUM_PROCS"]) > 1)
    mesh = data_mesh("cpu")
    d = np.load(data_path)
    X, y, Xq = d["X"], d["y"], d["Xq"]
    N = X.shape[0]
    Xp, _ = pad_rows(X, mesh.size)
    yp, _ = pad_rows(y, mesh.size)
    mask = np.zeros(Xp.shape[0])
    mask[:N] = 1.0
    Xl, yl, ml = (shard_rows(mesh, a) for a in (Xp, yp, mask))
    out = {}
    for approx in APPROXES:
        m = model(approx, X, y)
        nlml = make_dist_objective(m.spec, mesh, m.bias, m.fixed_scales, N)
        f, g = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)(m.theta)
        out[f"{approx}_f"], out[f"{approx}_g"] = f, g
    for approx in ("dtc", "ftc"):
        m = model(approx, X, y)
        step = make_dist_train_step(m.spec, mesh, m.bias, m.fixed_scales, N)
        res = step(m.theta, Xl, yl, ml, 5)
        out[f"scg_{approx}_x"], out[f"scg_{approx}_obj"] = res.x, res.obj
        out[f"scg_{approx}_iters"] = res.iters
    Xs, ys, n_valid = multihost.load_svml_sharded(svml_path, mesh)
    out["svml_X"], out["svml_y"], out["svml_n"] = Xs, ys, n_valid
    out["row_range"] = np.array(multihost.process_row_range(n_valid + (-n_valid) % mesh.size,
                                                            mesh))
    for approx in ("ftc", "fitc"):
        m = model(approx, X, y)
        server = GPServer(m, chunk=8 * mesh.size, mesh=mesh)
        for rows in (37, 5):
            mu, var = server.predict(Xq[:rows])
            out[f"serve_{approx}_{rows}_mu"], out[f"serve_{approx}_{rows}_var"] = mu, var
        out[f"bucket_{approx}"] = np.array([server._bucket(t) for t in (1, 3, 5, 8, 13)])
    np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
