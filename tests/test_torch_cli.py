"""The port's gp CLI (gpc_tpu_torch.cli.gp) against gpc_tpu.cli.gp.

Both CLIs run in-process on one synthetic SVM-light file and one model file
written by gpc_tpu; the port runs with `--device cpu`.  display / test /
predict / log-likelihood must print the same text, with every number equal
to float64 rounding (rtol 1e-10).  `learn -# 20` of both packages gives
hyperparameters within 1e-6 relative after the same number of iterations,
and each package relearns from the other's model file.  `learn -# 10` with
each kernel type of the -k grammar (ARD under -i 1) gives hyperparameters
within 1e-7, and each package reads the other's model file.  The sparse
approximations (-A with -a) under each optimiser (-O) learn as gpc_tpu's do
(tolerances at the test), and `gnuplot` writes gpc_tpu's files: the same
text and names, the posterior's numbers within 1e-12 of the largest.  The
unported paths (a classification model's noise, -f 1), flags out of place
and a missing card exit with an error.
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
    # a classification model's file (its noise models are not ported yet)
    with open("probit_model", "w") as f:
        f.write(open("gp_model").read().replace("type=gaussian", "type=probit"))
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
    (["gnuplot", "train.svml", "probit_model"], "not yet ported"),
    (["display", "probit_model"], "not yet ported"),
    (["log-likelihood", "train.svml", "probit_model"], "not yet ported"),
    (["test", "train.svml", "probit_model"], "not yet ported"),
    (["predict", "train.svml", "probit_model"], "not yet ported"),
    (["relearn", "train.svml", "probit_model"], "not yet ported"),
    (["learn", "-f", "1", "train.svml"], "not yet ported"),
    (["learn", "-k", "foo", "train.svml"], "Unknown covariance function type"),
    (["learn", "-g", "1.0", "train.svml"], "must come after covariance"),
    (["learn", "-O", "bogus", "train.svml"], "Unrecognised optimiser"),
    (["learn", "-A", "bogus", "train.svml"], "Unknown sparse approximation"),
    (["relearn", "-x", "train.svml", "gp_model"], "Unrecognised flag"),
    (["bogus"], "Invalid gp command"),
    (["display", "missing_model"], "Unable to read file"),
    ([], "No command provided"),
    (["learn", "-k", "rbf", "-w", "1.0", "train.svml"], "`Weight variance' parameter not valid for rbf"),
    (["learn", "-k", "mlp", "-d", "3", "train.svml"], "Polynomial degree parameter not valid for mlp"),
    (["learn", "-k", "poly", "-@", "2", "train.svml"], "Alpha parameter not valid for poly"),
    (["learn", "-k", "lin", "-g", "2", "train.svml"], "Inverse width parameter not valid for lin"),
    (["learn", "-k", "exp", "-i", "1", "train.svml"], "Exponential covariance function not available"),
    (["learn", "-k", "ratquad", "-i", "1", "train.svml"], "Rational quadratic covariance function not"),
    (["learn", "-k", "matern32", "-i", "1", "train.svml"], "matern32 covariance function not available"),
    (["learn", "-k", "mlp", "-i", "2", "train.svml"], "is not boolean"),
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


ZOO = [["-k", "mlp"], ["-k", "poly", "-d", "3"], ["-k", "lin", "-i", "1"], ["-k", "exp"],
       ["-k", "ratquad", "-@", "2"], ["-k", "matern52"],
       ["-k", "mlp", "-w", "2", "-b", "0.5", "-i", "1", "-k", "rbf", "-g", "0.4"]]


@pytest.fixture
def zoo_file(files):
    """Training data at half the spread of learn.svml: there the Grams of
    every kernel type stay conditioned well enough that the two packages'
    last-bit differences (XLA fuses a·b + c into one multiply-add) stay
    below 1e-8 over 10 SCG iterations; at twice the spread poly of degree 3
    drifts 1e-6."""
    rng = np.random.default_rng(5)
    X = 0.5 * rng.standard_normal((150, 2))
    write_svml("zoo.svml", X, np.sin(X[:, :1]) + 0.2 * rng.standard_normal((150, 1)))
    return "zoo.svml"


@pytest.mark.parametrize("flags", ZOO, ids=lambda f: "".join(f))
def test_learn_kernel_zoo_matches_jax(zoo_file, capsys, flags):
    """learn -# 10 with each leaf type of the CLI grammar: the learned θ
    within 1e-7 of gpc_tpu's (as tests/test_torch_train.py holds
    GP.optimise), the same display, and each package reads the other's
    model file to the same log-likelihood."""
    argv = ["learn", "-#", "10"] + flags + [zoo_file]
    out_j = _run(jax_cli.main, ["-s", "1"] + argv + ["m_jax"], capsys)
    out_t = _run(port_cli.main, CPU + ["-s", "1"] + argv + ["m_port"], capsys)
    p_j, obj_j, it_j = _learned(out_j)
    p_t, obj_t, it_t = _learned(out_t)
    assert it_t == it_j == 10 and len(p_t) == len(p_j) > 2
    np.testing.assert_allclose(p_t, p_j, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-8)
    assert [ln.split(":")[0] for ln in out_t.splitlines()] == \
        [ln.split(":")[0] for ln in out_j.splitlines()]
    for reader, model in ((port_cli.main, "m_jax"), (jax_cli.main, "m_port")):
        ll = _run(reader, (CPU if reader is port_cli.main else []) +
                  ["log-likelihood", zoo_file, model], capsys)
        np.testing.assert_allclose(float(ll.split(":")[-1]), -obj_j, rtol=1e-7)
    text = {f: "".join(ln for ln in open(f) if not ln.startswith("#"))
            for f in ("m_port", "m_jax")}
    assert _NUM.sub("#", text["m_port"]) == _NUM.sub("#", text["m_jax"])


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


@pytest.mark.parametrize("argv,message", [
    (["learn", "-A", "dtc", "train.svml"], "You must choose an active set size"),
    (["learn", "-A", "pitc", "-a", "0", "train.svml"], "You must choose an active set size"),
    (["relearn", "-O", "bogus", "train.svml", "gp_model"], "Unrecognised optimiser"),
    (["gnuplot", "-x", "train.svml", "gp_model"], "Unrecognised flag"),
    (["gnuplot", "three.svml", "gp_model"], "Incorrect dimension of input data"),
    (["gnuplot", "three.svml", "three_model"], "Incorrect number of model inputs"),
])
def test_sparse_and_gnuplot_errors_match_jax(files, capsys, argv, message):
    """The sparse and gnuplot error messages are gpc_tpu's."""
    rng = np.random.default_rng(2)
    X3 = rng.standard_normal((20, 3))
    write_svml("three.svml", X3, X3[:, :1])
    JIO.write_gp("three_model", JGP(GK.Cmpnd(input_dim=3, components=(
        GK.Rbf(input_dim=3), GK.White(input_dim=3))), X3, X3[:, :1]))
    for main, pre in ((port_cli.main, CPU), (jax_cli.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(pre + argv)
        assert message in str(exc.value.code)


@pytest.fixture
def sparse_file(files):
    """1-D data for the sparse CLI: a sinc-like curve of 80 points."""
    rng = np.random.default_rng(8)
    X = rng.uniform(-3.0, 3.0, (80, 1))
    write_svml("sparse.svml", X, np.sinc(X) + 0.05 * rng.standard_normal((80, 1)))
    return "sparse.svml"


# -O scg amplifies the objectives' last-bit differences through its
# finite-difference curvature probe (test_learn_matches_jax holds it to 1e-6)
SPARSE_LEARN = [("dtc", "scg", 1e-6), ("dtcvar", "conjgrad", 1e-8), ("fitc", "quasinew", 1e-8),
                ("pitc", "graddesc", 1e-10), ("fitc", "scg", 1e-6), ("dtc", "quasinew", 1e-8)]


@pytest.mark.parametrize("approx,optimiser,rtol", SPARSE_LEARN)
def test_sparse_learn_matches_jax(sparse_file, capsys, approx, optimiser, rtol):
    """learn -A approx -a 8 -O optimiser -# 6: the same printed summary
    (hyperparameters and β within rtol), the same inducing inputs, and each
    package reads the other's model file to the same log-likelihood; then
    relearn -O quasinew from the other package's file."""
    argv = ["-s", "3", "learn", "-A", approx, "-a", "8", "-O", optimiser, "-#", "6", sparse_file]
    out_j = _run(jax_cli.main, argv + ["m_jax"], capsys)
    out_t = _run(port_cli.main, CPU + argv + ["m_port"], capsys)
    assert ("Warning: numerical stabilities" in out_t) == (approx == "dtcvar")
    p_j, obj_j, it_j = _learned(out_j)
    p_t, obj_t, it_t = _learned(out_t)
    assert it_t == it_j and "  beta: " in out_t and len(p_t) == len(p_j) == 5
    np.testing.assert_allclose(p_t, p_j, rtol=rtol)
    np.testing.assert_allclose(obj_t, obj_j, rtol=rtol)
    jm, pm = JIO.read_gp("m_jax"), JIO.read_gp("m_port")
    assert pm.spec.approx == approx and pm.spec.num_active == 8
    np.testing.assert_allclose(pm.inducing(), np.asarray(jm.inducing()), rtol=10 * rtol,
                               atol=1e-12)
    ll = float(_run(port_cli.main, CPU + ["log-likelihood", sparse_file, "m_port"],
                    capsys).split(":")[-1])
    ll_j = float(_run(jax_cli.main, ["log-likelihood", sparse_file, "m_port"],
                      capsys).split(":")[-1])
    np.testing.assert_allclose(ll, ll_j, rtol=1e-10)
    if optimiser != "graddesc":     # gd reports f at the iterate before its last
        np.testing.assert_allclose(ll, -obj_t, rtol=1e-10)
    out_r = _run(port_cli.main, CPU + ["relearn", "-O", "quasinew", "-#", "2", sparse_file,
                                       "m_jax", "m_next"], capsys)
    out_rj = _run(jax_cli.main, ["relearn", "-O", "quasinew", "-#", "2", sparse_file,
                                 "m_jax", "m_next_jax"], capsys)
    np.testing.assert_allclose(_learned(out_r)[0], _learned(out_rj)[0], rtol=1e-8)


def _gnuplot_files(name):
    import glob
    return sorted(f[len(name):] for f in glob.glob(name + "_*"))


@pytest.mark.parametrize("case", ["ftc_1d", "dtc_1d", "fitc_2d", "ftc_2d"])
def test_gnuplot_matches_jax(files, sparse_file, capsys, case):
    """gnuplot of a learned model: the same files; the script, the scatter
    data and everything else that carries no posterior value byte for
    byte, the rest the same text with numbers within 1e-12 of the file's
    largest (both packages' posterior values differ in their last bits)."""
    approx, dims = case.split("_")
    data = sparse_file if dims == "1d" else "train.svml"
    argv = ["-s", "2", "learn", "-A", approx, "-a", "6", "-#", "3", data, "m"]
    jax_cli.main(argv)
    flags = ["-r", "17", "-p", "1.5"] if dims == "2d" else []
    jax_cli.main(["gnuplot"] + flags + [data, "m", "jplot"])
    port_cli.main(CPU + ["gnuplot"] + flags + [data, "m", "tplot"])
    names = _gnuplot_files("jplot")
    assert names == _gnuplot_files("tplot")
    want = {"1d": ["_error_bar_data.dat", "_line_data.dat", "_plot.gp", "_scatter_data.dat"],
            "2d": ["_output_matrix.dat", "_plot.gp", "_scatter_data.dat"]}[dims]
    assert set(names) == set(want + (["_active_set.dat"] if approx != "ftc" else []))
    for suffix in names:
        ref = open("jplot" + suffix).read().replace("jplot", "NAME")
        got = open("tplot" + suffix).read().replace("tplot", "NAME")
        if suffix in ("_plot.gp", "_scatter_data.dat"):
            assert got == ref
            continue
        assert _NUM.sub("#", got) == _NUM.sub("#", ref)
        a = np.array([float(v) for v in _NUM.findall(got)])
        b = np.array([float(v) for v in _NUM.findall(ref)])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
