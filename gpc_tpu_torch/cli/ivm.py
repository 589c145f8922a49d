"""`ivm` command-line tool on PyTorch (counterpart of gpc_tpu/cli/ivm.py):
IVM classification / regression / NCNM.

Commands (ivm.cpp:35-50): learn / relearn / test / log-likelihood / predict
/ class-one-probabilities / display / gnuplot, with gpc_tpu's flags,
messages and files: -o classification|regression|ncnm (the NCNM upgrade of
a data set with unlabelled points), -a, -k and the kernel grammar (default
lin), -# / -n / -e, -l labelled indices, -c / -r phase-boundary
checkpoints, and -O, which is validated only, as in gpc_tpu.  Usage:

    python -m gpc_tpu_torch.cli.ivm [-v verbosity] [-s seed] [--device cpu|cuda] COMMAND ...

Every command runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

import numpy as np

import torch

from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch import noise as NZ
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.cli.common import (CommandLine, ExitError, KernelSpecParser,
                                      load_data, write_unheaded)
from gpc_tpu_torch.io import model_io
from gpc_tpu_torch.models.ivm import IVM


def _help():
    print("IVM tool (gpc_tpu_torch).\n"
          "Commands: learn relearn test log-likelihood predict "
          "class-one-probabilities display gnuplot\n"
          "Learn options: -o classification|regression|ncnm  -a active-set-size\n"
          "  -k kernel -g gamma -v variance -w weight -b bias -d degree -i input-select\n"
          "  -# kernel-iters (100) -n noise-iters (20) -e external-iters (4)\n"
          "  -l labelled-indices-file  -O optimiser\n"
          "  -c ckpt-file [-r resume]  phase-boundary preemption checkpoints\n"
          "Global options: -v verbosity -s seed --device cpu|cuda (default cuda)")


def _select_noise(cl, y, out_type, labelled_idx):
    """Noise model selection incl. NCNM auto-upgrade (ivm.cpp:427-475)."""
    D = y.shape[1]
    if out_type == "ncnm":
        ok = np.isin(y, [1.0, -1.0, 0.0]) | np.isnan(y)
        if not ok.all():
            raise ExitError("Input data is not a classification data set. "
                            "Labels must either be -1.0, 1.0 or (for unlabelled) 0.0")
        return NZ.NcnmNoise(output_dim=D)
    if out_type == "classification":
        vals = y[~np.isnan(y)]
        bad = ~np.isin(vals, [1.0, -1.0, 0.0])
        if bad.any():
            raise ExitError("Input data is not a classification data set. "
                            "Labels must either be -1.0, 1.0 or (for unlabelled) 0.0")
        if bool((~np.isin(y, [1.0, -1.0])).any()):
            if cl.verbosity > 0:
                print("Some data are missing labels, using null category noise model.")
            return NZ.NcnmNoise(output_dim=D)
        return NZ.ProbitNoise(output_dim=D)
    if out_type == "regression":
        return NZ.GaussianNoise(output_dim=D)
    raise ExitError("Unknown output type, valid types are 'classification', "
                    "'regression' and 'ncnm' (null category noise model).")


def learn(cl: CommandLine):
    cl.advance()
    cl.mode = "learn"
    ks = KernelSpecParser()
    out_type = "classification"
    kern_iters, noise_iters, ext_iters = 100, 20, 4
    active = -1
    labelled_file = None
    model_file = "ivm_model"
    ckpt_path, resume = None, False
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-?", "-h", "--help"):
            _help()
            return
        elif arg in ("-c", "--checkpoint"):
            # phase-boundary preemption checkpoints (models/ivm.optimise) —
            # the IVM alternation is the longest tutorial workload and the
            # reference restarts it from scratch (CIvm.cpp:685-736)
            ckpt_path = cl.get_string(); cl.advance()
        elif arg in ("-r", "--resume"):
            resume = True; cl.advance()
        elif arg in ("-l", "--labelled-indices-file"):
            labelled_file = cl.get_string(); cl.advance()
        elif arg in ("-o", "--output-type"):
            out_type = cl.get_string(); cl.advance()
        elif arg in ("-O", "--optimiser"):
            opt = cl.get_string(); cl.advance()
            if opt not in ("scg", "conjgrad", "graddesc", "quasinew"):
                raise ExitError("Unrecognised model optimiser type.")
        elif arg in ("-#", "--#kernel-iterations"):
            kern_iters = cl.get_int(); cl.advance()
        elif arg in ("-n", "--noise-iterations"):
            noise_iters = cl.get_int(); cl.advance()
        elif arg in ("-e", "--external-iterations"):
            ext_iters = cl.get_int(); cl.advance()
        elif arg in ("-a", "--active-set-size"):
            active = cl.get_int(); cl.advance()
        elif arg in ("-f", "--file-format"):
            cl.file_format = cl.get_int(); cl.advance()
        elif ks.handle(cl):
            pass
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    if active == -1:
        raise ExitError("You must choose an active set size (option -a) for the command learn.")
    data_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        model_file = cl.argv[cl.pos + 1]

    X, y = load_data(data_file, cl.file_format)
    labelled_idx = None
    if labelled_file:
        with open(labelled_file) as f:
            labelled_idx = [int(ln) - 1 for ln in f if ln.strip()]
        for i in labelled_idx:
            if i < 0 or i >= y.shape[0]:
                raise ExitError(f"Bad index in {labelled_file}")

    noise = _select_noise(cl, y, out_type, labelled_idx)
    if labelled_file:
        if isinstance(noise, NZ.NcnmNoise):
            # blank labels of unlisted points (ivm.cpp:492-504)
            mask = np.ones(y.shape[0], bool)
            mask[labelled_idx] = False
            y = y.copy()
            y[mask] = 0.0
            if cl.verbosity > 0:
                print(f"Removed labels from {int(mask.sum())} points that weren't indexed.")
        else:
            X, y = X[labelled_idx], y[labelled_idx]
            if cl.verbosity > 0:
                print(f"Reduced data set ... contains {y.shape[0]} points.")

    # gamma(1,1) prior on variances in NCNM mode (ivm.cpp:422-425)
    vprior = priors_mod.gamma(1.0, 1.0) if isinstance(noise, NZ.NcnmNoise) else None
    kern, kern_params = ks.build(X.shape[1], default_type="lin", variance_prior=vprior)

    model = IVM(kern, noise, X, y, num_active=active, seed=cl.seed,
                kern_params=kern_params, device=cl.device)
    model.optimise(ext_iters=ext_iters, kern_iters=kern_iters, noise_iters=noise_iters, verbose=cl.verbosity,
                   ckpt_path=ckpt_path, resume=resume)
    if cl.verbosity > 0:
        print(model.display())
    comment = "Run as: " + " ".join(sys.argv) + " "
    model_io.write_ivm(model_file, model, comment)


def relearn(cl: CommandLine):
    """Warm-start retraining (ivm.cpp:83-231): loads kernel + noise params
    from a saved model, rebuilds the IVM on (possibly new) data, and writes
    the result to the THIRD positional newModelFileName (default ivm_model)
    — the input model file is never overwritten unless named again."""
    cl.advance()
    kern_iters, noise_iters, ext_iters = 100, 20, 4
    active = -1
    labelled_file = None
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-#", "--#kernel-iterations"):
            kern_iters = cl.get_int(); cl.advance()
        elif arg in ("-n", "--noise-iterations"):
            noise_iters = cl.get_int(); cl.advance()
        elif arg in ("-e", "--external-iterations"):
            ext_iters = cl.get_int(); cl.advance()
        elif arg in ("-a", "--active-set-size"):
            active = cl.get_int(); cl.advance()
        elif arg in ("-l", "--labelled-indices-file"):
            labelled_file = cl.get_string(); cl.advance()
        elif arg in ("-O", "--optimiser"):
            opt = cl.get_string(); cl.advance()
            if opt not in ("scg", "conjgrad", "graddesc", "quasinew"):
                raise ExitError("Unrecognised model optimiser type.")
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    if active == -1:
        # the reference requires -a on relearn too (ivm.cpp:143-144)
        raise ExitError("You must choose an active set size (option -a) for the command learn.")
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else "ivm_model"
    new_model_file = (cl.argv[cl.pos + 2] if cl.pos + 2 < len(cl.argv)
                      else "ivm_model")
    X, y = load_data(data_file, cl.file_format)
    labelled_idx = None
    if labelled_file:
        with open(labelled_file) as f:
            labelled_idx = [int(ln) - 1 for ln in f if ln.strip()]
        for i in labelled_idx:
            if i < 0 or i >= y.shape[0]:
                raise ExitError(f"Bad index in {labelled_file}")
    stored = model_io.read_ivm(model_file, device=cl.device)
    if stored.spec.input_dim != X.shape[1]:
        # ivm.cpp:178-179
        raise ExitError(f"{data_file}: input data is not of correct dimension")
    if labelled_idx is not None:
        if stored.spec.noise.kind == "ncnm":
            # blank labels of unlisted rows, keep all points (ivm.cpp:183-206)
            mask = np.ones(y.shape[0], bool)
            mask[labelled_idx] = False
            y = y.copy()
            y[mask] = 0.0
            if cl.verbosity > 0:
                print(f"Removed labels from {int(mask.sum())} points that weren't indexed.")
        else:
            X, y = X[labelled_idx], y[labelled_idx]
            if cl.verbosity > 0:
                print(f"Reduced data set ... contains {y.shape[0]} points.")
    model = IVM(stored.spec.kern, stored.spec.noise, X, y, num_active=active,
                seed=cl.seed, kern_params=stored.kern_params,
                noise_params=stored.noise_params, device=cl.device)
    model.optimise(ext_iters=ext_iters, kern_iters=kern_iters, noise_iters=noise_iters, verbose=cl.verbosity)
    if cl.verbosity > 0:
        print(model.display())
    comment = "Run as: " + " ".join(sys.argv) + f" with seed {cl.seed}."
    model_io.write_ivm(new_model_file, model, comment)


def _load_model_and_data(cl, default_model="ivm_model"):
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else default_model
    X, y = load_data(data_file, cl.file_format)
    model = model_io.read_ivm(model_file, device=cl.device)
    if model.spec.input_dim != X.shape[1]:
        raise ExitError(f"{data_file}: input data is not of correct dimension")
    return model, X, y, model_file


def test_cmd(cl: CommandLine):
    cl.advance()
    model, X, y, _ = _load_model_and_data(cl)
    mu, vs = model.predict(X)
    metric = model.noise_apply("test_metric", mu, vs, y)
    for j, v in enumerate(np.atleast_1d(np.asarray(metric))):
        if model.spec.noise.kind == "gaussian":
            print(f"Mean Squared Error on output {j + 1}: {float(v)}")
        else:
            print(f"Classification error on output {j + 1}: {float(v) * 100.0}%.")


def log_likelihood_cmd(cl: CommandLine):
    cl.advance()
    model, X, y, _ = _load_model_and_data(cl)
    mu, vs = model.predict(X)
    ll = float(model.noise_apply("log_likelihood", mu, vs, y))
    ll += float(priors_mod.total_log_prob(model.spec.kern.priors_global,
                                          torch.as_tensor(model.kern_params)))
    print(f"Model log likelihood: {ll}")


def predict(cl: CommandLine):
    cl.advance()
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else "ivm_model"
    pred_file = cl.argv[cl.pos + 2] if cl.pos + 2 < len(cl.argv) else "ivm_predictions"
    X, _ = load_data(data_file, cl.file_format)
    model = model_io.read_ivm(model_file, device=cl.device)
    yPred = model.out(X)
    write_unheaded(pred_file, yPred)


def class_one_probabilities(cl: CommandLine):
    cl.advance()
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else "ivm_model"
    out_file = cl.argv[cl.pos + 2] if cl.pos + 2 < len(cl.argv) else "ivm_probabilities"
    X, _ = load_data(data_file, cl.file_format)
    model = model_io.read_ivm(model_file, device=cl.device)
    mu, vs = model.predict(X)
    ones = np.ones((X.shape[0], model.spec.output_dim))
    probs = model.noise_apply("likelihoods", mu, vs, ones)
    write_unheaded(out_file, probs)


def display(cl: CommandLine):
    cl.advance()
    model_file = cl.current() if cl.has_more() else "ivm_model"
    model = model_io.read_ivm(model_file, device=cl.device)
    print(model.display())


def _gnuplot_regression(model, X, y, name, resolution, point_size, line_width):
    """Gaussian-noise IVM plot branch (ivm.cpp:1087-1202): active set with
    target column, scatter data, then a 1-D line + ±1σ error-bar pair or a
    2-D output-surface matrix, plus the driving script."""
    idx = model.state.active_idx.cpu().numpy()
    write_unheaded(f"{name}_active_set.dat",
                   np.hstack([model.active_X(), model.y[idx][:, :1]]))
    write_unheaded(f"{name}_scatter_data.dat", np.hstack([X, y[:, :1]]))
    mins, maxs = X.min(0), X.max(0)
    q = model.spec.input_dim
    if q == 2:  # ivm.cpp:1108-1156
        nx = ny = resolution
        xs = np.linspace(mins[0], maxs[0], nx)
        ys = np.linspace(mins[1], maxs[1], ny)
        XX, YY = np.meshgrid(xs, ys)
        grid = np.column_stack([XX.ravel(), YY.ravel()])
        mu, vs = model.predict(grid)
        out = model.noise_apply("out", mu, vs)
        out = out[:, 0].reshape(ny, nx)
        with open(f"{name}_output_matrix.dat", "w") as f:
            f.write("# Prepared plot of model file \n")
            for i in range(ny):
                for j in range(nx):
                    f.write(f"{xs[j]:.17e} {ys[i]:.17e} {out[i, j]:.17e}\n")
                f.write("\n")
        with open(f"{name}_plot.gp", "w") as f:
            f.write(f'splot "{name}_output_matrix.dat"  with lines lw {line_width}'
                    f', "{name}_scatter_data.dat" with points ps {point_size}'
                    f', "{name}_active_set.dat" with points ps {point_size}\n'
                    "pause -1")
    elif q == 1:  # ivm.cpp:1157-1202 (note ±1σ bars, unlike gp's ±2σ)
        xs = np.linspace(mins[0], maxs[0], resolution)
        mu, vs = model.predict(xs.reshape(-1, 1))
        out = model.noise_apply("out", mu, vs)[:, 0]
        std = model.noise_apply("out_std", mu, vs)[:, 0]
        write_unheaded(f"{name}_line_data.dat", np.column_stack([xs, out]))
        with open(f"{name}_error_bar_data.dat", "w") as f:
            f.write("# Prepared plot of model file \n")
            for xv, m, s in zip(xs, out, std):
                f.write(f"{xv:.17e} {m + s:.17e}\n")
            f.write("\n")
            for xv, m, s in zip(xs, out, std):
                f.write(f"{xv:.17e} {m - s:.17e}\n")
        with open(f"{name}_plot.gp", "w") as f:
            f.write(f'plot "{name}_line_data.dat" with lines lw {line_width}'
                    f', "{name}_scatter_data.dat" with points ps {point_size}'
                    f', "{name}_active_set.dat" with points ps {point_size}'
                    f', "{name}_error_bar_data.dat" with lines lw {line_width}\n'
                    "pause -1")
    # q > 2: the reference emits only the scatter/active files (falls through
    # both dimension branches, ivm.cpp:1108/1157)


def gnuplot(cl: CommandLine):
    """Classification probability grid + 0.5/0.25/0.75 contour script
    (probit/ncnm branch, ivm.cpp:967-1086) or the gaussian-noise regression
    plot (ivm.cpp:1087-1202)."""
    cl.advance()
    point_size, line_width, resolution = 2.0, 2.0, 80
    name, model_file = "ivm", "ivm_model"
    while cl.is_flag():
        arg = cl.current()
        if arg in ("-p", "--point-size"):
            point_size = cl.get_double(); cl.advance()
        elif arg in ("-r", "--resolution"):
            resolution = cl.get_int(); cl.advance()
        else:
            raise ExitError(f"Unrecognised flag: {cl.current()}")
    data_file = cl.current()
    if cl.pos + 1 < len(cl.argv):
        model_file = cl.argv[cl.pos + 1]
    if cl.pos + 2 < len(cl.argv):
        name = cl.argv[cl.pos + 2]
    X, y = load_data(data_file, cl.file_format)
    try:
        model = model_io.read_ivm(model_file, X=X, y=y, device=cl.device)
    except model_io.DataDimensionError:
        raise ExitError("Incorrect dimension of input data.")
    if model.spec.noise.kind == "gaussian":
        _gnuplot_regression(model, X, y, name, resolution, point_size,
                            line_width)
        return
    if model.spec.noise.kind not in ("probit", "ncnm"):
        raise ExitError("Unknown noise model for gnuplot output.")
    if model.spec.input_dim != 2:
        raise ExitError("Incorrect number of model inputs.")

    write_unheaded(f"{name}_active_set.dat",
                   np.hstack([model.active_X(), np.zeros((model.spec.num_active, 1))]))
    pos, neg, unlab = y[:, 0] == 1.0, y[:, 0] == -1.0, ~((y[:, 0] == 1.0) | (y[:, 0] == -1.0))
    for mask, tag in ((pos, "positive"), (neg, "negative"), (unlab, "unlabelled")):
        if mask.any():
            write_unheaded(f"{name}_{tag}.dat",
                           np.hstack([X[mask], np.zeros((int(mask.sum()), 1))]))

    mins, maxs = X.min(0), X.max(0)
    xs = np.linspace(mins[0], maxs[0], resolution)
    ys = np.linspace(mins[1], maxs[1], resolution)
    XX, YY = np.meshgrid(xs, ys)
    grid = np.column_stack([XX.ravel(), YY.ravel()])
    mu, vs = model.predict(grid)
    ones = np.ones((grid.shape[0], 1))
    probs = model.noise_apply("likelihoods", mu, vs, ones)[:, 0]
    probs = probs.reshape(resolution, resolution)
    with open(f"{name}_prob_matrix.dat", "w") as f:
        f.write("# Prepared plot of model file \n")
        for i in range(resolution):
            for j in range(resolution):
                f.write(f"{xs[j]:.17e} {ys[i]:.17e} {probs[i, j]:.17e}\n")
            f.write("\n")
    with open(f"{name}_plot.gp", "w") as f:
        f.write("set nosurface\nset contour base\n"
                "set cntrparam levels discrete 0.5\nset term table\n"
                f"set out '{name}_decision.dat'\nsplot \"{name}_prob_matrix.dat\"\n"
                "set cntrparam levels discrete 0.25, 0.75\n"
                f"set out '{name}_contours.dat'\nsplot \"{name}_prob_matrix.dat\"\n"
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


COMMANDS = {"learn": learn, "relearn": relearn, "test": test_cmd,
            "log-likelihood": log_likelihood_cmd, "predict": predict,
            "class-one-probabilities": class_one_probabilities,
            "display": display, "gnuplot": gnuplot}


def main(argv=None):
    cl = CommandLine(argv if argv is not None else sys.argv[1:])
    cl.eat_global_flags()
    if not cl.has_more():
        _help()
        raise ExitError("No command provided.")
    np.random.seed(cl.seed % (2 ** 32))
    cmd = cl.current()
    if cmd not in COMMANDS:
        _help()
        raise ExitError(f"Invalid ivm command provided: {cmd}")
    try:
        COMMANDS[cmd](cl)
    except FileNotFoundError as e:
        raise ExitError(f"Unable to read file {e.filename}.")
    except (ValueError, NotImplementedError, NoDeviceError) as e:
        raise ExitError(str(e))


if __name__ == "__main__":
    main()
