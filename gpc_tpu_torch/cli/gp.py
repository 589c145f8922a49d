"""`gp` command-line tool on PyTorch (counterpart of gpc_tpu/cli/gp.py).

Commands: learn / relearn / display / gnuplot / test / predict /
log-likelihood, with the same flags, arguments, output and files as
gpc_tpu's: FTC and the sparse approximations (-A dtc|dtcvar|fitc|pitc with
-a M), every kernel type of gpc_tpu's gp CLI (-k lin|poly|rbf|exp|ratquad|
mlp|matern32|matern52, ARD under -i 1) and the optimisers -O scg|conjgrad|
graddesc|quasinew.  A model file keeps its noise block, and gnuplot of a
model with probit or ncnm noise takes gpc_tpu's classification branch.
-f 1 reads a MATLAB .mat data file (variables X and y).  Usage:

    python -m gpc_tpu_torch.cli.gp [-v verbosity] [-s seed] [--device cpu|cuda] COMMAND ...

Every command runs on the card unless `--device cpu` is given.
GPC_TPU_EVIDENCE=dense|lazy|panel selects the evidence engine of
log-likelihood and of training, as in gpc_tpu.
"""

from __future__ import annotations

import sys

import numpy as np

from gpc_tpu_torch import NoDeviceError, as_tensor
from gpc_tpu_torch.cli.common import (CommandLine, ExitError, KernelSpecParser,
                                      load_data, write_unheaded)
from gpc_tpu_torch.io import model_io
from gpc_tpu_torch.models.gp import GP

OPTIMISERS = ("scg", "conjgrad", "graddesc", "quasinew")
SPARSE = ("dtc", "dtcvar", "fitc", "pitc")


def _help():
    print("GP regression tool (gpc_tpu_torch).\n"
          "Commands:\n"
          "  gp learn [options] data.svml [model]    train a GP\n"
          "  gp relearn [options] data.svml model [new_model]  continue training\n"
          "  gp display [model]                      show a stored model\n"
          "  gp gnuplot [options] data.svml [model] [name]  plot artifacts\n"
          "  gp test data.svml [model]               MSE against targets\n"
          "  gp predict data.svml [model] [out]      posterior means to file\n"
          "  gp log-likelihood data.svml [model]     marginal likelihood\n"
          "Global options: -v verbosity -s seed --device cpu|cuda (default cuda)\n"
          "Learn options: -C centre (1) -S scale (0) -L learn-scales (0)\n"
          "  -A ftc|dtc|dtcvar|fitc|pitc  -a active-set-size\n"
          "  -k kernel (rbf|lin|mlp|poly|exp|ratquad|matern32|matern52)\n"
          "  -g gamma -@ alpha -v variance -w weight-var -b bias-var -d degree\n"
          "  -i input-select  -O scg|conjgrad|graddesc|quasinew  -# iters  -f format\n"
          "  -c ckpt-file [--checkpoint-every N] [-r resume]  SCG checkpoints\n"
          "Gnuplot options: -p point-size (2) -r resolution (80) -l labels (unused)")


def _report_and_write(cl, model, res, model_file):
    if cl.verbosity > 0:
        print(model.display())
        print(f"Final objective: {float(res.obj)} after {int(res.iters)} iterations")
    comment = "Run as: " + " ".join(sys.argv) + f" with seed {cl.seed}."
    model_io.write_gp(model_file, model, comment)


def learn(cl: CommandLine):
    cl.advance()
    ks = KernelSpecParser()
    centre, scale_data, learn_scales = True, False, False
    approx, active = "ftc", -1
    iters = 1000
    optimiser = "scg"
    model_file = "gp_model"
    ckpt_path, ckpt_every, resume = None, 50, False
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-?", "-h", "--help"):
            _help()
            return
        elif arg in ("-c", "--checkpoint"):
            ckpt_path = cl.get_string(); cl.advance()
        elif arg == "--checkpoint-every":
            ckpt_every = cl.get_int(); cl.advance()
        elif arg in ("-r", "--resume"):
            resume = True; cl.advance()
        elif arg in ("-C", "--Centre-data"):
            centre = cl.get_bool(); cl.advance()
        elif arg in ("-L", "--Learn-scales"):
            learn_scales = cl.get_bool(); cl.advance()
        elif arg in ("-S", "--Scale-data"):
            scale_data = cl.get_bool(); cl.advance()
        elif arg in ("-a", "--active-set-size"):
            active = cl.get_int(); cl.advance()
        elif arg in ("-A", "--Approximation-type"):
            approx = cl.get_string(); cl.advance()
        elif arg in ("-O", "--optimiser"):
            optimiser = cl.get_string(); cl.advance()
        elif arg in ("-#", "--#iterations"):
            iters = cl.get_int(); cl.advance()
        elif arg in ("-f", "--file-format"):
            cl.file_format = cl.get_int(); cl.advance()
        elif ks.handle(cl):
            pass
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    data_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        model_file = cl.argv[cl.pos + 1]
    if approx == "ftc":
        active = 0
    elif approx == "dtcvar":
        print("Warning: numerical stabilities exist in DTCVAR approximation.")
    elif approx not in SPARSE:
        raise ExitError(f"Unknown sparse approximation type: {approx}.")
    # fitc and pitc too: gpc_tpu implements both, though the reference CLI
    # blocks FITC (gp.cpp:363-366) and stubs PITC (CGp.cpp:862-871)
    if approx != "ftc" and active <= 0:
        raise ExitError("You must choose an active set size (option -a) for the command learn.")
    if optimiser not in OPTIMISERS:
        raise ExitError(f"Unrecognised optimiser type: {optimiser}")

    X, y = load_data(data_file, cl.file_format)
    kern, kern_params = ks.build(X.shape[1])
    model = GP(kern, X, y, approx=approx, num_active=active, learn_scales=learn_scales,
               centre=centre, scale_data=scale_data, beta=1.0, seed=cl.seed,
               device=cl.device)
    # the CLI-specified kernel parameters replace the kernel defaults
    model.theta = model.spec.pack(kern_params, X_u=model.inducing(),
                                  scales=model.fixed_scales if learn_scales else None,
                                  beta=1.0 if model.spec.sparse else None)
    res = model.optimise(iters=iters, optimiser=optimiser, verbose=cl.verbosity,
                         ckpt_path=ckpt_path, ckpt_every=ckpt_every, resume=resume)
    _report_and_write(cl, model, res, model_file)


def relearn(cl: CommandLine):
    cl.advance()
    iters = 1000
    optimiser = "scg"
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-#", "--#iterations"):
            iters = cl.get_int(); cl.advance()
        elif arg in ("-O", "--optimiser"):
            optimiser = cl.get_string(); cl.advance()
            if optimiser not in OPTIMISERS:
                raise ExitError(f"Unrecognised optimiser type: {optimiser}")
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    # the retrained model goes to the THIRD positional argument (default
    # gp_model); the input model file is overwritten only when named again
    # (gp.cpp:446-447, 480-515)
    new_model_file = cl.argv[cl.pos + 2] if cl.pos + 2 < len(cl.argv) else "gp_model"
    model, _, _ = _load_model_and_data(cl)
    res = model.optimise(iters=iters, optimiser=optimiser, verbose=cl.verbosity)
    _report_and_write(cl, model, res, new_model_file)


def _write_grid(path, xs, ys, Z):
    """x y z rows of a gnuplot grid, a blank line after each row of y."""
    with open(path, "w") as f:
        f.write("# Prepared plot of model file \n")
        for i in range(len(ys)):
            for j in range(len(xs)):
                f.write(f"{xs[j]:.17e} {ys[i]:.17e} {Z[i, j]:.17e}\n")
            f.write("\n")


def _gnuplot_classification(model, X, y, name, resolution, point_size, line_width):
    """The probit/ncnm branch (gp.cpp:635-750): the inducing set, the
    scatter of each class (a trailing 0 column), the class-one probability
    grid and the 0.5-decision / 0.25-0.75-contour script.  As in gpc_tpu,
    the grid holds the noise model's probabilities (the reference streams an
    unfilled matrix, gp.cpp:709), and the script plots `name`_active_set.dat,
    as the reference emits it (gp.cpp:745), though this branch writes the
    inducing set to `name`_inducing_set.dat (gp.cpp:638)."""
    if model.spec.sparse:
        write_unheaded(f"{name}_inducing_set.dat", model.inducing())
    pos = y[:, 0] == 1.0
    neg = y[:, 0] == -1.0
    unlab = ~(pos | neg)
    for mask, tag in ((pos, "positive"), (neg, "negative"), (unlab, "unlabelled")):
        if mask.any():
            write_unheaded(f"{name}_{tag}.dat",
                           np.hstack([X[mask], np.zeros((int(mask.sum()), 1))]))
    mins, maxs = X.min(0), X.max(0)
    xs = np.linspace(mins[0], maxs[0], resolution)
    ys = np.linspace(mins[1], maxs[1], resolution)
    XX, YY = np.meshgrid(xs, ys)
    mu, vs = model.predict(np.column_stack([XX.ravel(), YY.ravel()]))
    noise = model_io.make_noise_from_stream(model.noise_type, model.spec.output_dim,
                                            model.noise_extra)
    dev = model.device
    probs = noise.likelihoods(as_tensor(model.noise_params, dev), as_tensor(mu, dev),
                              as_tensor(vs, dev), as_tensor(np.ones_like(mu), dev))
    _write_grid(f"{name}_prob_matrix.dat", xs, ys,
                probs[:, 0].cpu().numpy().reshape(resolution, resolution))
    with open(f"{name}_plot.gp", "w") as f:
        f.write("set nosurface\nset contour base\n"
                "set cntrparam levels discrete 0.5\n"
                "set term table # set output type to tables\n"
                f"set out '{name}_decision.dat'\n"
                f'splot "{name}_prob_matrix.dat"\n'
                "set cntrparam levels discrete 0.25, 0.75\n"
                f"set out '{name}_contours.dat'\n"
                f'splot "{name}_prob_matrix.dat"\n'
                "reset\nset term x11\nplot ")
        parts = []
        if pos.any():
            parts.append(f'"{name}_positive.dat" with points ps {point_size}')
        if neg.any():
            parts.append(f'"{name}_negative.dat" with points ps {point_size}')
        parts.append(f'"{name}_active_set.dat" with points ps {point_size * 2}')
        if unlab.any():
            parts.append(f'"{name}_unlabelled.dat" with points ps {point_size}')
        parts.append(f'"{name}_decision.dat" with lines lw {line_width}')
        parts.append(f'"{name}_contours.dat" with lines lw {line_width}')
        f.write(", ".join(parts) + "\npause -1\n")


def gnuplot(cl: CommandLine):
    """Plot artifacts (gp.cpp:567-906).  A regression model: the data
    scatter, a sparse model's active set at its posterior means, and for
    q = 1 the mean line with ±2σ bars or for q = 2 the mean on a grid, with
    the driving script `name`_plot.gp; a probit or ncnm model: the
    classification branch.  Files and their text are gpc_tpu's
    (gpc_tpu/cli/gp.py:210-377)."""
    cl.advance()
    resolution = 80
    point_size, line_width = 2.0, 2.0
    name = "gp"
    model_file = "gp_model"
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-p", "--point-size"):
            point_size = cl.get_double(); cl.advance()
        elif arg in ("-r", "--resolution"):
            resolution = cl.get_int(); cl.advance()
        elif arg in ("-l", "--labels"):
            # parsed and unused, as in the reference (gp.cpp:586-588)
            cl.get_string(); cl.advance()
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    data_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        model_file = cl.argv[cl.pos + 1]
    if cl.pos + 2 < len(cl.argv):
        name = cl.argv[cl.pos + 2]

    X, y = load_data(data_file, cl.file_format)
    try:
        model = model_io.read_gp(model_file, X=X, y=y, device=cl.device)
    except model_io.DataDimensionError:
        raise ExitError("Incorrect dimension of input data.")
    q = model.spec.input_dim
    noise_type = model.noise_type
    if (q != 2) if noise_type != "gaussian" else (q > 2):     # gp.cpp:624-631
        raise ExitError("Incorrect number of model inputs.")
    if noise_type in ("probit", "ncnm"):
        _gnuplot_classification(model, X, y, name, resolution, point_size, line_width)
        return
    sigma2 = float(model.noise_params[-1])
    sparse = model.spec.sparse
    if sparse:
        Xu = model.inducing()
        mu_u, _ = model.predict(Xu)
        write_unheaded(f"{name}_active_set.dat", np.hstack([Xu, mu_u[:, :1]]))
    write_unheaded(f"{name}_scatter_data.dat", np.hstack([X, y[:, :1]]))

    mins, maxs = X.min(axis=0), X.max(axis=0)
    if q == 2:
        xs = np.linspace(mins[0], maxs[0], resolution)
        ys = np.linspace(mins[1], maxs[1], resolution)
        XX, YY = np.meshgrid(xs, ys)
        mu, _ = model.predict(np.column_stack([XX.ravel(), YY.ravel()]))
        _write_grid(f"{name}_output_matrix.dat", xs, ys,
                    mu[:, 0].reshape(resolution, resolution))
        with open(f"{name}_plot.gp", "w") as f:
            f.write(f'splot "{name}_output_matrix.dat"  with lines lw {line_width}'
                    f', "{name}_scatter_data.dat" with points ps {point_size}')
            if sparse:
                f.write(f', "{name}_active_set.dat" with points ps {point_size}\n')
            f.write("pause -1")
        return
    overlap = 0.25
    span = maxs[0] - mins[0]
    xs = np.linspace(mins[0] - overlap * span, maxs[0] + overlap * span, resolution)
    mu, var = model.predict(xs.reshape(-1, 1))
    mu = mu[:, 0]
    std = np.sqrt(var[:, 0] + sigma2)
    write_unheaded(f"{name}_line_data.dat", np.column_stack([xs, mu]))
    with open(f"{name}_error_bar_data.dat", "w") as f:
        f.write("# Prepared plot of model file \n")
        for xv, m, s in zip(xs, mu, std):
            f.write(f"{xv:.17e} {m + 2 * s:.17e}\n")
        f.write("\n")
        for xv, m, s in zip(xs, mu, std):
            f.write(f"{xv:.17e} {m - 2 * s:.17e}\n")
    with open(f"{name}_plot.gp", "w") as f:
        f.write(f'plot "{name}_line_data.dat" with lines lw {line_width}'
                f', "{name}_scatter_data.dat" with points ps {point_size}')
        if sparse:
            f.write(f', "{name}_active_set.dat" with points ps {point_size}')
        f.write(f', "{name}_error_bar_data.dat" with lines lw {line_width}\n')
        f.write("pause -1")


def display(cl: CommandLine):
    cl.advance()
    model_file = cl.current() if cl.has_more() else "gp_model"
    print(model_io.read_gp(model_file, device=cl.device).display())


def _load_model_and_data(cl, default_model="gp_model"):
    """Re-attach the given data to a stored model (gp.cpp:620-622)."""
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else default_model
    X, y = load_data(data_file, cl.file_format)
    try:
        model = model_io.read_gp(model_file, X=X, y=y, device=cl.device)
    except model_io.DataDimensionError:
        raise ExitError(f"{data_file}: input data is not of correct dimension")
    return model, X, y


def test_cmd(cl: CommandLine):
    """Mean squared error of the posterior mean at the data inputs."""
    cl.advance()
    model, X, y = _load_model_and_data(cl)
    mu, _ = model.predict(X)
    mse = np.mean((np.asarray(y) - np.asarray(mu)) ** 2, axis=0)
    for j, v in enumerate(np.atleast_1d(mse)):
        print(f"Mean Squared Error on output {j + 1}: {float(v)}")


def predict_cmd(cl: CommandLine):
    """Posterior means at the data inputs, written unheaded."""
    cl.advance()
    model, X, _ = _load_model_and_data(cl)
    pred_file = cl.argv[cl.pos + 2] if cl.pos + 2 < len(cl.argv) else "gp_predictions"
    mu, _ = model.predict(X)
    write_unheaded(pred_file, np.asarray(mu))


def log_likelihood_cmd(cl: CommandLine):
    """Marginal log likelihood of the stored hyperparameters on the data."""
    cl.advance()
    model, _, _ = _load_model_and_data(cl)
    print(f"Model log likelihood: {model.log_likelihood()}")


COMMANDS = {"learn": learn, "relearn": relearn, "gnuplot": gnuplot,
            "display": display, "test": test_cmd, "predict": predict_cmd,
            "log-likelihood": log_likelihood_cmd}


def main(argv=None):
    cl = CommandLine(argv if argv is not None else sys.argv[1:])
    cl.eat_global_flags()
    if not cl.has_more():
        _help()
        raise ExitError("No command provided.")
    cmd = cl.current()
    if cmd not in COMMANDS:
        _help()
        raise ExitError(f"Invalid gp command provided: {cmd}")
    try:
        COMMANDS[cmd](cl)
    except FileNotFoundError as e:
        raise ExitError(f"Unable to read file {e.filename}.")
    except (ValueError, NotImplementedError, NoDeviceError) as e:
        raise ExitError(str(e))


if __name__ == "__main__":
    main()
