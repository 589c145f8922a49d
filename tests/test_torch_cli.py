"""The port's gp CLI (gpc_tpu_torch.cli.gp) against gpc_tpu.cli.gp.

Both CLIs run in-process on one synthetic SVM-light file and one model file
written by gpc_tpu.  display / test / predict / log-likelihood must print
the same text, with every number equal to float64 rounding (rtol 1e-10);
the unported commands exit with an error.
"""

import re

import numpy as np
import pytest
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.cli import gp as jax_cli
from gpc_tpu.io import model_io as JIO
from gpc_tpu.io.svml import write_svml
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu_torch.cli import gp as port_cli

_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(21)
    X = rng.standard_normal((60, 2))
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((60, 1))
    write_svml("train.svml", X, y)
    kern = GK.Cmpnd(input_dim=2, components=(
        GK.Rbf(input_dim=2), GK.Bias(input_dim=2), GK.White(input_dim=2)))
    model = JGP(kern, X, y, centre=True)
    model.theta = jnp.asarray(np.array([0.4, -0.2, -1.5, -3.0]))
    JIO.write_gp("gp_model", model)
    return tmp_path


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _same_output(port, ref):
    """Equal text around the numbers; numbers equal to rtol 1e-10."""
    assert _NUM.sub("#", port) == _NUM.sub("#", ref)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(port)],
                               [float(v) for v in _NUM.findall(ref)], rtol=1e-10)


@pytest.mark.parametrize("argv", [
    ["display", "gp_model"],
    ["test", "train.svml", "gp_model"],
    ["log-likelihood", "train.svml", "gp_model"],
])
def test_command_output_matches(files, capsys, argv):
    ref = _run(jax_cli.main, argv, capsys)
    port = _run(port_cli.main, argv, capsys)
    assert port.strip()
    _same_output(port, ref)


def test_predict_file_matches(files, capsys):
    jax_cli.main(["predict", "train.svml", "gp_model", "pred_jax"])
    port_cli.main(["predict", "train.svml", "gp_model", "pred_port"])
    ref, port = np.loadtxt("pred_jax"), np.loadtxt("pred_port")
    assert port.shape == ref.shape == (60,)
    np.testing.assert_allclose(port, ref, rtol=1e-10, atol=1e-13)


def test_panel_log_likelihood_matches_dense_cli(files, capsys, monkeypatch):
    ref = _run(jax_cli.main, ["log-likelihood", "train.svml", "gp_model"], capsys)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    port = _run(port_cli.main, ["log-likelihood", "train.svml", "gp_model"], capsys)
    _same_output(port, ref)


@pytest.mark.parametrize("argv,message", [
    (["learn", "train.svml"], "not yet ported"),
    (["relearn", "train.svml", "gp_model"], "not yet ported"),
    (["gnuplot", "train.svml", "gp_model"], "not yet ported"),
    (["bogus"], "Invalid gp command"),
    (["display", "missing_model"], "Unable to read file"),
    ([], "No command provided"),
])
def test_errors_exit_nonzero(files, capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(argv)
    assert message in str(exc.value.code)
