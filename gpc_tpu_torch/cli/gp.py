"""`gp` command-line tool on PyTorch (counterpart of gpc_tpu/cli/gp.py).

Ported commands: display / test / predict / log-likelihood, with the same
arguments and output as gpc_tpu's.  learn / relearn / gnuplot exit non-zero
until SCG training is ported.  Usage:

    python -m gpc_tpu_torch.cli.gp [-v verbosity] [-s seed] COMMAND ...

GPC_TPU_EVIDENCE=panel|dense selects the evidence engine of
log-likelihood, as in gpc_tpu.
"""

from __future__ import annotations

import sys

import numpy as np

from gpc_tpu_torch.cli.common import CommandLine, ExitError, write_unheaded
from gpc_tpu_torch.io import model_io
from gpc_tpu_torch.io.svml import read_svml


def _help():
    print("GP regression tool (gpc_tpu_torch).\n"
          "Commands:\n"
          "  gp display [model]                      show a stored model\n"
          "  gp test data.svml [model]               MSE against targets\n"
          "  gp predict data.svml [model] [out]      posterior means to file\n"
          "  gp log-likelihood data.svml [model]     marginal likelihood\n"
          "Not yet ported: learn, relearn, gnuplot.")


def not_ported(cl: CommandLine):
    raise ExitError(f"gp {cl.current()} is not yet ported to gpc_tpu_torch "
                    f"(SCG training comes next; use gpc_tpu.cli.gp)")


def display(cl: CommandLine):
    cl.advance()
    model_file = cl.current() if cl.has_more() else "gp_model"
    print(model_io.read_gp(model_file).display())


def _load_model_and_data(cl, default_model="gp_model"):
    """Re-attach the given data to a stored model (gp.cpp:620-622)."""
    data_file = cl.current()
    model_file = cl.argv[cl.pos + 1] if cl.pos + 1 < len(cl.argv) else default_model
    X, y = read_svml(data_file)
    try:
        model = model_io.read_gp(model_file, X=X, y=y)
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


COMMANDS = {"learn": not_ported, "relearn": not_ported, "gnuplot": not_ported,
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
    except ValueError as e:
        raise ExitError(str(e))


if __name__ == "__main__":
    main()
