"""`gp` command-line tool on PyTorch (counterpart of gpc_tpu/cli/gp.py).

Ported commands: learn / relearn / display / test / predict /
log-likelihood, with the same flags, arguments and output as gpc_tpu's, for
FTC with every kernel type of gpc_tpu's gp CLI (-k lin|poly|rbf|exp|ratquad|
mlp|matern32|matern52, ARD under -i 1).  gnuplot, the sparse approximations
and the optimisers other than scg exit "not yet ported".  Usage:

    python -m gpc_tpu_torch.cli.gp [-v verbosity] [-s seed] [--device cpu|cuda] COMMAND ...

Every command runs on the card unless `--device cpu` is given.
GPC_TPU_EVIDENCE=dense|lazy|panel selects the evidence engine of
log-likelihood and of training, as in gpc_tpu.
"""

from __future__ import annotations

import sys

import numpy as np

from gpc_tpu_torch import NoDeviceError
from gpc_tpu_torch.cli.common import (CommandLine, ExitError, KernelSpecParser,
                                      load_data, not_ported, write_unheaded)
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
          "  gp test data.svml [model]               MSE against targets\n"
          "  gp predict data.svml [model] [out]      posterior means to file\n"
          "  gp log-likelihood data.svml [model]     marginal likelihood\n"
          "Global options: -v verbosity -s seed --device cpu|cuda (default cuda)\n"
          "Learn options: -C centre (1) -S scale (0) -L learn-scales (0)\n"
          "  -A ftc  -k kernel (rbf|lin|mlp|poly|exp|ratquad|matern32|matern52)\n"
          "  -g gamma -@ alpha -v variance -w weight-var -b bias-var -d degree\n"
          "  -i input-select  -O scg  -# iters  -f format\n"
          "  -c ckpt-file [--checkpoint-every N] [-r resume]  SCG checkpoints\n"
          "Not yet ported: gnuplot; -A dtc|dtcvar|fitc|pitc;\n"
          "  -O conjgrad|graddesc|quasinew; -f 1.")


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
    approx = "ftc"
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
            cl.get_int(); cl.advance()        # FTC has no active set
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
    if approx in SPARSE:
        raise not_ported(f"approximation {approx}", "queue 1 item 7")
    if approx != "ftc":
        raise ExitError(f"Unknown sparse approximation type: {approx}.")
    if optimiser not in OPTIMISERS:
        raise ExitError(f"Unrecognised optimiser type: {optimiser}")

    X, y = load_data(data_file, cl.file_format)
    kern, kern_params = ks.build(X.shape[1])
    model = GP(kern, X, y, learn_scales=learn_scales, centre=centre,
               scale_data=scale_data, device=cl.device)
    # the CLI-specified kernel parameters replace the kernel defaults
    model.theta = model.spec.pack(kern_params,
                                  scales=model.fixed_scales if learn_scales else None)
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


def gnuplot(cl: CommandLine):
    raise not_ported("gp gnuplot", "queue 1 item 5")


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
