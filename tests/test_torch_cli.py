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
text and names, the posterior's numbers within 1e-12 of the largest.  -f 1
on a file that is not a .mat file, flags out of place and a missing card
exit with an error.  A GP model file with probit noise reads in both packages, and every
command on it (gnuplot's classification branch included) gives gpc_tpu's
output.  The ivm CLI (gpc_tpu_torch.cli.ivm): its 8 commands against
gpc_tpu.cli.ivm, with -l, -o ncnm, -o regression and -c/-r (tolerances at
the tests).  The gplvm CLI (gpc_tpu_torch.cli.gplvm): learn with each
option family (-D -dr -ds, -c, -L -S, -R -C, -I rand, -O conjgrad|
quasinew, -k with -x) gives gpc_tpu's model file, numbers within 1e-8;
display, gnuplot (labels from the file and from -l) and the error
messages are gpc_tpu's; --checkpoint/--resume ends where the
uninterrupted run ends.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.cli import gp as jax_cli
from gpc_tpu.cli import gplvm as jax_gplvm
from gpc_tpu.cli import ivm as jax_ivm
from gpc_tpu.io import model_io as JIO
from gpc_tpu.io.svml import write_svml
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu_torch.cli import gp as port_cli
from gpc_tpu_torch.cli import gplvm as port_gplvm
from gpc_tpu_torch.cli import ivm as port_ivm

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
    # a classification model's file: gnuplot takes its classification branch
    with open("probit_model", "w") as f:
        f.write(open("gp_model").read().replace("type=gaussian", "type=probit"))
    # ... and one at q = 3, where that branch refuses; a noise block whose
    # numParams disagrees with its matrix
    X3 = rng.standard_normal((30, 3))
    write_svml("train3.svml", X3, np.sign(X3[:, :1]))
    JIO.write_gp("g3", JGP(GK.Cmpnd(input_dim=3, components=(
        GK.Rbf(input_dim=3), GK.White(input_dim=3))), X3, X3[:, :1]))
    with open("probit3_model", "w") as f:
        f.write(open("g3").read().replace("type=gaussian", "type=probit"))
    with open("badnoise_model", "w") as f:
        f.write(open("gp_model").read().replace("outputDim=1\nnumParams=2", "outputDim=1\nnumParams=3"))
    return tmp_path


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _same_output(port, ref, rtol=1e-10):
    """Equal text around the numbers; numbers equal to rtol (1e-10)."""
    assert _NUM.sub("#", port) == _NUM.sub("#", ref)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(port)],
                               [float(v) for v in _NUM.findall(ref)], rtol=rtol)


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
    (["gnuplot", "train3.svml", "probit3_model"], "Incorrect number of model inputs"),
    (["display", "badnoise_model"], "noise numParams mismatch"),
    (["log-likelihood", "train3.svml", "probit_model"], "input data is not of correct dimension"),
    (["test", "train3.svml", "probit_model"], "input data is not of correct dimension"),
    (["predict", "train3.svml", "probit_model"], "input data is not of correct dimension"),
    (["gnuplot", "train3.svml", "probit_model"], "Incorrect dimension of input data"),
    (["learn", "-f", "1", "train.svml"], "Unable to read MATLAB file train.svml"),
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


@pytest.mark.parametrize("argv", [
    ["gnuplot", "-r", "9", "train.svml", "probit_model", "NAME"],
    ["display", "probit_model"],
    ["log-likelihood", "train.svml", "probit_model"],
    ["test", "train.svml", "probit_model"],
    ["predict", "train.svml", "probit_model", "NAME_predictions"],
    ["relearn", "-#", "3", "train.svml", "probit_model", "NAME_model"],
])
def test_probit_gp_model_matches_jax(files, capsys, argv):
    """A GP model file with probit noise: each command prints gpc_tpu's text
    (numbers to rtol 1e-10) and writes gpc_tpu's files (numbers within
    1e-12 of each file's largest); gnuplot takes the classification branch,
    whose script plots `name`_active_set.dat though it writes no such file
    (gpc_tpu's and the reference's quirk)."""
    outs = {}
    for main, pre, tag in ((jax_cli.main, [], "jax"), (port_cli.main, CPU, "port")):
        outs[tag] = _run(main, pre + [a.replace("NAME", tag) for a in argv], capsys)
    _same_output(outs["port"], outs["jax"])
    made = _gnuplot_files("port")
    if argv[0] == "gnuplot":
        # train.svml's targets are not ±1: every point is unlabelled
        assert made == ["_plot.gp", "_prob_matrix.dat", "_unlabelled.dat"]
        assert '"port_active_set.dat" with points ps 4.0' in open("port_plot.gp").read()
    for suffix in made:
        _same_file("jax" + suffix, "port" + suffix, "jax", "port")


def _same_file(ref_path, got_path, ref_name="jax", got_name="port", rtol=1e-12):
    """The same text around the numbers, the numbers within rtol of the
    file's largest; comment lines (the command line) are skipped."""
    read = lambda p, n: "".join(ln for ln in open(p) if not ln.startswith("#")).replace(n, "N")  # noqa: E731
    ref, got = read(ref_path, ref_name), read(got_path, got_name)
    assert _NUM.sub("#", got) == _NUM.sub("#", ref)
    a = np.array([float(v) for v in _NUM.findall(got)])
    b = np.array([float(v) for v in _NUM.findall(ref)])
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(initial=0), 1e-300))


@pytest.fixture(scope="module")
def ivm_dir(tmp_path_factory):
    """Classification data (80 points in [0, 1]², y = sign(x₁ + x₂ − 1)
    with every 13th label flipped), its labelled-index file, 1-D regression
    data, and one learned model per package:
    `learn -k rbf -a 20 -# 5 -n 3 -e 2` with seed 1."""
    d = tmp_path_factory.mktemp("ivm")
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (80, 2))
    y = np.where(X.sum(1, keepdims=True) > 1.0, 1.0, -1.0)
    y[::13] *= -1.0
    write_svml(str(d / "c.svml"), X, y)
    with open(d / "labelled", "w") as f:
        f.write("".join(f"{i + 1}\n" for i in range(0, 80, 2)))
    X1 = rng.uniform(-3.0, 3.0, (60, 1))
    write_svml(str(d / "r.svml"), X1, np.sinc(X1) + 0.05 * rng.standard_normal((60, 1)))
    learn = ["-s", "1", "learn", "-k", "rbf", "-a", "20", "-#", "5", "-n", "3", "-e", "2",
             str(d / "c.svml")]
    jax_ivm.main(learn + [str(d / "m_jax")])
    port_ivm.main(CPU + learn + [str(d / "m_port")])
    return d


def _ivm_params(out):
    """The kernel and noise parameters of a printed IVM summary."""
    return np.array([float(v) for v in
                     re.findall(r"^  (?:\w+|noise param \d+): (\S+)$", out, re.M)])


def _ivm_both(argv, capsys, d):
    """Run argv (MODEL, OUT and DIR substituted per package) in both; the
    two outputs."""
    outs = {}
    for main, pre, tag in ((jax_ivm.main, [], "jax"), (port_ivm.main, CPU, "port")):
        args = [a.replace("MODEL", str(d / f"m_{tag}")).replace("OUT", str(d / f"o_{tag}"))
                .replace("DIR", str(d)) for a in argv]
        outs[tag] = _run(main, pre + args, capsys)
    return outs["jax"], outs["port"]


IVM_COMMANDS = {
    "display": ["display", "MODEL"],
    "test": ["test", "DIR/c.svml", "MODEL"],
    "log-likelihood": ["log-likelihood", "DIR/c.svml", "MODEL"],
    "predict": ["predict", "DIR/c.svml", "MODEL", "OUT"],
    "class-one-probabilities": ["class-one-probabilities", "DIR/c.svml", "MODEL", "OUT"],
    "gnuplot": ["gnuplot", "-r", "11", "DIR/c.svml", "MODEL", "OUT"],
}


def test_ivm_learn_matches_jax(ivm_dir, capsys):
    """learn: the same learned parameters within rtol 1e-8 (SCG amplifies
    the last-bit differences of the objectives), the same active set and
    model-file text; each package reads the other's file."""
    j, t = (_ivm_params(_run(m, pre + ["display", str(ivm_dir / f)], capsys))
            for m, pre, f in ((jax_ivm.main, [], "m_jax"), (port_ivm.main, CPU, "m_port")))
    assert len(j) == len(t) == 5
    np.testing.assert_allclose(t, j, rtol=1e-8)
    text = {f: [ln for ln in open(ivm_dir / f) if not ln.startswith("#")]
            for f in ("m_jax", "m_port")}
    assert [ln for ln in text["m_port"] if ln.startswith("activeSet")] == \
        [ln for ln in text["m_jax"] if ln.startswith("activeSet")]
    assert _NUM.sub("#", "".join(text["m_port"])) == _NUM.sub("#", "".join(text["m_jax"]))
    assert open(ivm_dir / "m_port").readline().startswith("# Run as: ")
    cross = _run(port_ivm.main, CPU + ["display", str(ivm_dir / "m_jax")], capsys)
    _same_output(cross, _run(jax_ivm.main, ["display", str(ivm_dir / "m_jax")], capsys))


@pytest.mark.parametrize("command", list(IVM_COMMANDS))
def test_ivm_command_matches_jax(ivm_dir, capsys, command):
    """Each command on gpc_tpu's model file, in both packages: the same
    printed text (numbers to rtol 1e-10) and files (numbers within 1e-12 of
    each file's largest)."""
    argv = [a.replace("MODEL", "DIR/m_jax") for a in IVM_COMMANDS[command]]
    ref, got = _ivm_both(argv, capsys, ivm_dir)
    _same_output(got, ref)
    if command in ("predict", "class-one-probabilities"):
        _same_file(ivm_dir / "o_jax", ivm_dir / "o_port")
    if command == "gnuplot":
        names = sorted(p.name[len("o_jax"):] for p in ivm_dir.glob("o_jax_*"))
        assert names == sorted(p.name[len("o_port"):] for p in ivm_dir.glob("o_port_*"))
        assert "_prob_matrix.dat" in names and "_active_set.dat" in names
        for suffix in names:
            _same_file(ivm_dir / f"o_jax{suffix}", ivm_dir / f"o_port{suffix}", "o_jax", "o_port")


def test_ivm_relearn_matches_jax(ivm_dir, capsys):
    """relearn from the other package's model into the third argument."""
    ref, got = _ivm_both(["-s", "2", "relearn", "-a", "15", "-#", "3", "-n", "2", "-e", "1",
                          "DIR/c.svml", "DIR/m_jax", "OUT"], capsys, ivm_dir)
    np.testing.assert_allclose(_ivm_params(got), _ivm_params(ref), rtol=1e-8)
    assert "Active set size: 15" in got and len(_ivm_params(got)) == 5


@pytest.mark.parametrize("flags", [["-o", "ncnm", "-l", "DIR/labelled"],
                                   ["-l", "DIR/labelled"], ["-o", "ncnm"]],
                         ids=["ncnm-l", "probit-l", "ncnm"])
def test_ivm_learn_options_match_jax(ivm_dir, capsys, flags):
    """-o ncnm (NCNM with gamma priors on the variances), -l (NCNM blanks
    the unlisted labels, probit drops those rows): the same messages and
    parameters (rtol 1e-8); the default kernel lin (K4's plain version)."""
    argv = ["-s", "3", "learn"] + flags + ["-a", "12", "-#", "3", "-n", "2", "-e", "1",
                                           "DIR/c.svml", "OUT"]
    ref, got = _ivm_both(argv, capsys, ivm_dir)
    assert [ln for ln in got.splitlines() if not ln.startswith("  ")] == \
        [ln for ln in ref.splitlines() if not ln.startswith("  ")]
    np.testing.assert_allclose(_ivm_params(got), _ivm_params(ref), rtol=1e-8)
    assert "linvariance" in got
    text = open(ivm_dir / "o_port").read()
    assert ("type=ncnm" in text) == ("ncnm" in flags) and ("priorIndex" in text) == (
        "ncnm" in flags)


def test_ivm_regression_and_gnuplot_match_jax(ivm_dir, capsys):
    """-o regression (Gaussian noise) on 1-D data, then gnuplot's regression
    branch: the line, ±1σ bars, active set and scatter files."""
    _ivm_both(["-s", "4", "learn", "-o", "regression", "-k", "rbf", "-a", "15", "-#", "3",
               "-n", "2", "-e", "1", "DIR/r.svml", "OUT"], capsys, ivm_dir)
    for tag in ("jax", "port"):
        (ivm_dir / f"reg_{tag}").write_text((ivm_dir / f"o_{tag}").read_text())
    ref, got = _ivm_both(["gnuplot", "DIR/r.svml", "DIR/reg_jax", "OUT"], capsys, ivm_dir)
    names = sorted(p.name[len("o_jax"):] for p in ivm_dir.glob("o_jax_*") if "prob" not in p.name
                   and "positive" not in p.name and "negative" not in p.name)
    assert {"_line_data.dat", "_error_bar_data.dat", "_scatter_data.dat"} <= set(names)
    for suffix in ("_line_data.dat", "_error_bar_data.dat", "_active_set.dat", "_plot.gp"):
        _same_file(ivm_dir / f"o_jax{suffix}", ivm_dir / f"o_port{suffix}", "o_jax", "o_port",
                   rtol=1e-10)


def test_ivm_checkpoint_resume(ivm_dir, capsys):
    """-c/-r: a run that stopped after one external iteration and resumed
    from its phase-boundary checkpoint ends where the uninterrupted run
    ends, bit for bit."""
    base = ["-s", "5", "learn", "-k", "rbf", "-a", "10", "-#", "2", "-n", "2"]
    data = str(ivm_dir / "c.svml")
    ck = str(ivm_dir / "ivm.ckpt.npz")
    full = _run(port_ivm.main, CPU + base + ["-e", "2", data, str(ivm_dir / "full")], capsys)
    port_ivm.main(CPU + base + ["-e", "1", "-c", ck, data, str(ivm_dir / "half")])
    capsys.readouterr()
    resumed = _run(port_ivm.main, CPU + base + ["-e", "2", "-c", ck, "-r", data,
                                                str(ivm_dir / "resumed")], capsys)
    assert len(_ivm_params(full)) == 5
    np.testing.assert_array_equal(_ivm_params(resumed), _ivm_params(full))


@pytest.mark.parametrize("argv,message", [
    (["learn", "DIR/c.svml"], "You must choose an active set size"),
    (["learn", "-a", "5", "-o", "bogus", "DIR/c.svml"], "Unknown output type"),
    (["learn", "-a", "5", "-O", "bogus", "DIR/c.svml"], "Unrecognised model optimiser type"),
    (["learn", "-a", "5", "-o", "ncnm", "DIR/r.svml"], "not a classification data set"),
    (["learn", "-a", "500", "DIR/c.svml"], "has to be less than number of data"),
    (["relearn", "-#", "2", "DIR/c.svml", "DIR/m_jax"], "You must choose an active set size"),
    (["test", "DIR/r.svml", "DIR/m_jax"], "input data is not of correct dimension"),
    (["gnuplot", "-x", "DIR/c.svml", "DIR/m_jax"], "Unrecognised flag"),
    (["bogus"], "Invalid ivm command"),
    ([], "No command provided"),
])
def test_ivm_errors_match_jax(ivm_dir, argv, message):
    for main, pre in ((port_ivm.main, CPU), (jax_ivm.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(pre + [a.replace("DIR", str(ivm_dir)) for a in argv])
        assert message in str(exc.value.code)


def test_ivm_without_card_exits(ivm_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_ivm.main(["display", str(ivm_dir / "m_jax")])
    assert "--device cpu" in str(exc.value.code)



# --------------------------------------------------------------------------
# the gplvm CLI
# --------------------------------------------------------------------------

@pytest.fixture
def gplvm_dir(tmp_path, monkeypatch):
    """An SVM-light file of 30 rows, 3 features on a 1-d curve, and
    integer labels (plotted per label)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(31)
    t = np.linspace(0, 2 * np.pi, 30)
    Y = np.column_stack([np.sin(t), np.cos(t), np.sin(2 * t)]) + 0.05 * rng.standard_normal((30, 3))
    write_svml("y.svml", Y, (np.arange(30) % 3).reshape(-1, 1).astype(float))
    return tmp_path


def _same_model_file(port_file, jax_file, rtol=1e-8):
    """The same text around the numbers (the comment line aside: it names
    the process), numbers within rtol of the largest of their kind."""
    port = open(port_file).read().split("\n", 1)[1]
    ref = open(jax_file).read().split("\n", 1)[1]
    assert _NUM.sub("#", port) == _NUM.sub("#", ref)
    a = np.array([float(v) for v in _NUM.findall(port)])
    b = np.array([float(v) for v in _NUM.findall(ref)])
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


GPLVM_LEARN = [[], ["-D", "rbf"], ["-D", "rbf", "-dr", "-1"],
               ["-D", "rbf", "-dr", "10", "-ds", "0.3"], ["-c", "rbf", "-g", "0.5"],
               ["-L", "1", "-S", "1"], ["-R", "0", "-C", "0"], ["-I", "rand"],
               ["-O", "conjgrad"], ["-O", "quasinew"], ["-k", "mlp", "-x", "3"]]


@pytest.mark.parametrize("flags", GPLVM_LEARN, ids=lambda f: "".join(f) or "default")
def test_gplvm_learn_matches_jax(gplvm_dir, capsys, flags):
    argv = ["-s", "7", "learn", "-#", "8"] + flags + ["y.svml"]
    ref = _run(jax_gplvm.main, argv + ["m_jax"], capsys)
    port = _run(port_gplvm.main, CPU + argv + ["m_port"], capsys)
    _same_output(port, ref, rtol=1e-8)
    _same_model_file("m_port", "m_jax")
    assert open("m_port").readline() == open("m_jax").readline()   # the comment


@pytest.mark.parametrize("command", [["display", "MODEL"], ["gnuplot", "MODEL", "NAME"],
                                     ["gnuplot", "-l", "labels", "-p", "3", "-r", "12",
                                      "MODEL", "NAME"]])
def test_gplvm_commands_match_jax(gplvm_dir, capsys, command):
    """display and gnuplot on a file gpc_tpu learned: gpc_tpu's output and
    files (the posterior's numbers within 1e-10)."""
    jax_gplvm.main(["-s", "1", "learn", "-#", "5", "-D", "rbf", "y.svml", "m"])
    with open("labels", "w") as f:
        f.write("\n".join(str(i % 2) for i in range(30)) + "\n")
    capsys.readouterr()
    outs = {}
    for tag, main, pre in (("jax", jax_gplvm.main, []), ("port", port_gplvm.main, CPU)):
        os.makedirs(tag)
        argv = [{"MODEL": "m", "NAME": f"{tag}/pl"}.get(a, a) for a in command]
        outs[tag] = _run(main, pre + argv, capsys)
        if command[0] == "gnuplot":
            outs[tag] = {f: open(os.path.join(tag, f)).read() for f in sorted(os.listdir(tag))}
    if command[0] == "display":
        _same_output(outs["port"], outs["jax"])
        return
    assert sorted(outs["port"]) == sorted(outs["jax"]) and len(outs["jax"]) >= 3
    for name, text in outs["jax"].items():
        got = outs["port"][name].replace("port/", "jax/")
        assert _NUM.sub("#", got) == _NUM.sub("#", text)
        a = np.array([float(v) for v in _NUM.findall(got)])
        b = np.array([float(v) for v in _NUM.findall(text)])
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max())


def test_gplvm_checkpoint_resume(gplvm_dir, capsys):
    """--checkpoint/--checkpoint-every/--resume: a run resumed from its
    checkpoint ends where the uninterrupted run ends, and where gpc_tpu's
    uninterrupted run ends (1e-8)."""
    base = CPU + ["-s", "2", "learn"]
    port_gplvm.main(base + ["-#", "10", "y.svml", "m_full"])
    port_gplvm.main(base + ["-#", "5", "--checkpoint", "ck.npz", "--checkpoint-every", "5",
                            "y.svml", "m_half"])
    port_gplvm.main(base + ["-#", "10", "--checkpoint", "ck.npz", "--checkpoint-every", "5",
                            "--resume", "y.svml", "m_resumed"])
    jax_gplvm.main(["-s", "2", "learn", "-#", "10", "y.svml", "m_jax"])
    assert capsys.readouterr().out.count("after 10 iterations") == 3
    full, resumed = (open(f).read().split("\n", 1)[1] for f in ("m_full", "m_resumed"))
    assert full == resumed
    _same_model_file("m_resumed", "m_jax")


@pytest.mark.parametrize("argv,message", [
    (["learn", "-dr", "5", "y.svml"], "declare a dynamics kernel before setting the dynamics "
                                      "signal"),
    (["learn", "-ds", "5", "y.svml"], "declare a dynamics kernel before setting the dynamics "
                                      "scale"),
    (["learn", "-I", "bogus", "y.svml"], "Unknown initialisation type: bogus"),
    (["learn", "-O", "bogus", "y.svml"], "Unrecognised model optimiser type"),
    (["learn", "-k", "bias", "y.svml"], "Unknown covariance function type: bias"),
    (["learn", "-g", "1", "y.svml"], "must come after covariance"),
    (["learn", "-q", "y.svml"], "Unrecognised flag: -q"),
    (["gnuplot", "-z", "m"], "Unrecognised flag: -z"),
    (["display", "nothere"], "Unable to read file nothere"),
    (["bogus"], "Invalid gplvm command provided: bogus"),
    ([], "No command provided"),
])
def test_gplvm_errors_match_jax(gplvm_dir, argv, message):
    for main, pre in ((port_gplvm.main, CPU), (jax_gplvm.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(pre + argv)
        assert message in str(exc.value.code)


def test_gplvm_gnuplot_errors_match_jax(gplvm_dir):
    """A 3-d latent space does not plot; a label file must have a row per
    point."""
    port_gplvm.main(CPU + ["learn", "-#", "1", "-x", "3", "y.svml", "m3"])
    port_gplvm.main(CPU + ["learn", "-#", "1", "y.svml", "m2"])
    with open("short", "w") as f:
        f.write("1\n2\n")
    for argv, message in ((["gnuplot", "m3"], "only implemented for 2 dimensional latent"),
                          (["gnuplot", "-l", "short", "m2"], "Incorrect number of labels")):
        for main, pre in ((port_gplvm.main, CPU), (jax_gplvm.main, [])):
            with pytest.raises(SystemExit) as exc:
                main(pre + argv)
            assert message in str(exc.value.code)


def test_gplvm_unported_format_and_no_card(gplvm_dir, monkeypatch):
    """-f 1 reads a .mat file, so an SVM-light file under it exits with
    gpc_tpu's message, as gp and ivm do; without a card and without
    --device cpu every command exits naming the flag."""
    with pytest.raises(SystemExit, match="Unable to read MATLAB file y.svml"):
        port_gplvm.main(CPU + ["learn", "-f", "1", "y.svml"])
    port_gplvm.main(CPU + ["learn", "-#", "1", "y.svml", "m"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["learn", "-#", "1", "y.svml"], ["display", "m"]):
        with pytest.raises(SystemExit) as exc:
            port_gplvm.main(argv)
        assert "--device cpu" in str(exc.value.code)
