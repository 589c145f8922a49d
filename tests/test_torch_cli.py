"""The port's gp CLI (gpc_tpu_torch.cli.gp) against gpc_tpu.cli.gp.

Both CLIs run in-process on one synthetic SVM-light file and one model file
written by gpc_tpu; the port runs with `--device cpu`.  display / test /
predict / log-likelihood must print the same text, with every number equal
to float64 rounding (rtol 1e-10).  `learn -# 20` of both packages gives
hyperparameters within 1e-6 relative after the same number of iterations,
and each package relearns from the other's model file.  The unported
commands, flags and a missing card exit with an error.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.cli import gp as jax_cli
from gpc_tpu.io import model_io as JIO
from gpc_tpu.io.svml import write_svml
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu_torch.cli import gp as port_cli

CPU = ["--device", "cpu"]

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
    port = _run(port_cli.main, CPU + argv, capsys)
    assert port.strip()
    _same_output(port, ref)


def test_predict_file_matches(files, capsys):
    jax_cli.main(["predict", "train.svml", "gp_model", "pred_jax"])
    port_cli.main(CPU + ["predict", "train.svml", "gp_model", "pred_port"])
    ref, port = np.loadtxt("pred_jax"), np.loadtxt("pred_port")
    assert port.shape == ref.shape == (60,)
    np.testing.assert_allclose(port, ref, rtol=1e-10, atol=1e-13)


def test_panel_log_likelihood_matches_dense_cli(files, capsys, monkeypatch):
    ref = _run(jax_cli.main, ["log-likelihood", "train.svml", "gp_model"], capsys)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "panel")
    port = _run(port_cli.main, CPU + ["log-likelihood", "train.svml", "gp_model"], capsys)
    _same_output(port, ref)


@pytest.mark.parametrize("argv,message", [
    (["gnuplot", "train.svml", "gp_model"], "not yet ported"),
    (["learn", "-k", "lin", "train.svml"], "not yet ported"),
    (["learn", "-k", "rbf", "-i", "1", "train.svml"], "not yet ported"),
    (["learn", "-k", "rbf", "-w", "1.0", "train.svml"], "not yet ported"),
    (["learn", "-A", "dtc", "-a", "10", "train.svml"], "not yet ported"),
    (["learn", "-O", "quasinew", "train.svml"], "not yet ported"),
    (["learn", "-f", "1", "train.svml"], "not yet ported"),
    (["learn", "-k", "foo", "train.svml"], "Unknown covariance function type"),
    (["learn", "-g", "1.0", "train.svml"], "must come after covariance"),
    (["learn", "-O", "bogus", "train.svml"], "Unrecognised optimiser"),
    (["learn", "-A", "bogus", "train.svml"], "Unknown sparse approximation"),
    (["relearn", "-x", "train.svml", "gp_model"], "Unrecognised flag"),
    (["bogus"], "Invalid gp command"),
    (["display", "missing_model"], "Unable to read file"),
    ([], "No command provided"),
])
def test_errors_exit_nonzero(files, capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(CPU + argv)
    assert message in str(exc.value.code)


def test_no_card_without_device_flag_exits(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["display", "gp_model"])
    assert "--device cpu" in str(exc.value.code)
    with pytest.raises(SystemExit, match="Unknown device"):
        port_cli.main(["--device", "tpu", "display", "gp_model"])


@pytest.fixture
def learn_file(files):
    """Training data on which 20 SCG iterations stay well conditioned: the
    two packages' float64 gradients differ in their last bits, and SCG's
    finite-difference curvature probe amplifies that on flat objectives."""
    rng = np.random.default_rng(5)
    X = 2.0 * rng.standard_normal((150, 2))
    write_svml("learn.svml", X, np.sin(X[:, :1]) + 0.2 * rng.standard_normal((150, 1)))
    return "learn.svml"


def _params(out):
    """The hyperparameters of a printed model summary."""
    return np.array([float(v) for v in re.findall(r"^  \w+: (\S+)$", out, re.M)])


def _learned(out):
    """(hyperparameters, final objective, iterations) printed by learn."""
    obj, iters = re.search(r"Final objective: (\S+) after (\d+) iterations", out).groups()
    return _params(out), float(obj), int(iters)


@pytest.mark.parametrize("flags", [[], ["-k", "rbf", "-g", "0.3", "-v", "0.8", "-L", "1", "-S", "1"]])
def test_learn_matches_jax(learn_file, capsys, flags):
    argv = ["learn", "-#", "20"] + flags + [learn_file]
    p_j, obj_j, it_j = _learned(_run(jax_cli.main, ["-s", "1"] + argv + ["m_jax"], capsys))
    p_t, obj_t, it_t = _learned(_run(port_cli.main, CPU + ["-s", "1"] + argv + ["m_port"], capsys))
    assert it_t == it_j == 20 and len(p_t) == len(p_j) == 4
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-7)
    # the written models agree, and each package reads the other's
    np.testing.assert_allclose(JIO.read_gp("m_port", X=None).kern_params(),
                               JIO.read_gp("m_jax").kern_params(), rtol=1e-6)
    assert open("m_port").readline().startswith("# Run as: ")
    ll = _run(port_cli.main, CPU + ["log-likelihood", learn_file, "m_port"], capsys)
    np.testing.assert_allclose(float(ll.split(":")[-1]), -obj_t, rtol=1e-10)


def test_relearn_cross_loads(learn_file, capsys):
    """Each package continues training from the other's model file and
    writes to the third positional argument, leaving the input file as it
    was; the two continuations agree."""
    jax_cli.main(["learn", "-#", "5", learn_file, "m_jax"])
    port_cli.main(CPU + ["learn", "-#", "5", learn_file, "m_port"])
    before = open("m_jax").read()
    capsys.readouterr()
    out_t = _run(port_cli.main, CPU + ["relearn", "-#", "4", learn_file, "m_jax", "next_port"], capsys)
    out_j = _run(jax_cli.main, ["relearn", "-#", "4", learn_file, "m_port", "next_jax"], capsys)
    assert open("m_jax").read() == before
    p_t, obj_t, it_t = _learned(out_t)
    p_j, obj_j, it_j = _learned(out_j)
    assert it_t == it_j == 4
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6)
    back = _run(port_cli.main, CPU + ["display", "next_jax"], capsys)
    _same_output(back, _run(jax_cli.main, ["display", "next_jax"], capsys))


def test_learn_checkpoint_resume(files, capsys):
    """-c/--checkpoint-every/-r: a run resumed from its checkpoint ends
    where the uninterrupted run ends."""
    port_cli.main(CPU + ["learn", "-#", "12", "train.svml", "m_full"])
    port_cli.main(CPU + ["learn", "-#", "6", "-c", "ck.npz", "--checkpoint-every", "3",
                         "train.svml", "m_half"])
    port_cli.main(CPU + ["learn", "-#", "12", "-c", "ck.npz", "--checkpoint-every", "3",
                         "-r", "train.svml", "m_resumed"])
    out = capsys.readouterr().out
    assert out.count("after 12 iterations") == 2
    full = _params(_run(port_cli.main, CPU + ["display", "m_full"], capsys))
    resumed = _params(_run(port_cli.main, CPU + ["display", "m_resumed"], capsys))
    assert len(full) == 4
    np.testing.assert_array_equal(resumed, full)
