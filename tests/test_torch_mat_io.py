""".mat interop of the port (gpc_tpu_torch/io/mat_io.py) and the CLIs' -f 1
against gpc_tpu's.

The structs the port writes are gpc_tpu's byte for byte (each file after
its 128-byte header, which carries the time of writing) for every leaf
kernel, cmpnd and tensor and every noise type; whole GP files for FTC, DTC,
DTCVAR, FITC and PITC with fixed inducing inputs hold the same variables
and fields, with numbers within 1e-15 (the constrained parameters pass
through each package's exp).  Each package reads the
other's files: kernels to the same parameters and Gram (1e-12), models to
the same log-likelihood (1e-10 relative).  `load_data(path, 1)` gives
gpc_tpu's arrays and error messages, and gp / ivm / gplvm under -f 1 give
what they give under -f 0 on the same data (bit for bit) and gpc_tpu's
-f 1 output (1e-10, and 1e-8 for learned parameters: SCG amplifies the
last-bit differences of the objectives)."""

import io
import re

import numpy as np
import pytest
import scipy.io as sio
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.cli import common as JC
from gpc_tpu.cli import gp as jax_gp
from gpc_tpu.cli import gplvm as jax_gplvm
from gpc_tpu.cli import ivm as jax_ivm
from gpc_tpu.io import mat_io as JM
from gpc_tpu.io.svml import write_svml
from gpc_tpu.models.gp import GP as JGP
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.cli import common as TC
from gpc_tpu_torch.cli import gp as port_gp
from gpc_tpu_torch.cli import gplvm as port_gplvm
from gpc_tpu_torch.cli import ivm as port_ivm
from gpc_tpu_torch.interop.from_jax import from_jax
from gpc_tpu_torch.io import mat_io as TM

CPU = ["--device", "cpu"]
_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")
LEAVES = ["white", "whitefixed", "bias", "rbf", "exp", "ratquad", "matern32", "matern52",
          "lin", "mlp", "poly", "linard", "rbfard", "mlpard", "polyard"]


def _mat_bytes(data) -> bytes:
    """A .mat file's bytes after its 128-byte header."""
    buf = io.BytesIO()
    sio.savemat(buf, data)
    return buf.getvalue()[128:]


def _same_mat(a, b):
    """Equal loadmat trees: names, strings and shapes equal, numbers within
    1e-15 relative."""
    if isinstance(a, np.ndarray) and a.dtype.names:
        assert a.dtype.names == b.dtype.names and a.shape == b.shape
        for name in a.dtype.names:
            for x, y in zip(a[name].ravel(), b[name].ravel()):
                _same_mat(x, y)
    elif isinstance(a, np.ndarray) and a.dtype == object:
        assert a.shape == b.shape
        for x, y in zip(a.ravel(), b.ravel()):
            _same_mat(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind in "US":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-15, atol=0)


def _kw(kind):
    if kind in ("poly", "polyard"):
        return {"degree": 3.0}
    if kind == "whitefixed":
        return {"fixed_variance": 0.0125}
    return {}


def _kern_pair(kind, q=3):
    """(gpc_tpu kernel, port kernel) of one kind; cmpnd and tensor take a
    few children."""
    if kind == "cmpnd":
        kinds = ["rbf", "matern52", "poly", "rbfard", "whitefixed", "bias", "white"]
    elif kind == "tensor":
        kinds = ["rbf", "lin"]
    else:
        return GK.make_kern(kind, q, **_kw(kind)), TK.make_kern(kind, q, **_kw(kind))
    j = [GK.make_kern(k, q, **_kw(k)) for k in kinds]
    t = [TK.make_kern(k, q, **_kw(k)) for k in kinds]
    return GK.make_kern(kind, q, components=tuple(j)), TK.make_kern(kind, q, components=tuple(t))


@pytest.mark.parametrize("kind", LEAVES + ["cmpnd", "tensor"])
def test_kern_struct_both_ways(kind, tmp_path):
    jk, tk = _kern_pair(kind)
    rng = np.random.default_rng(LEAVES.index(kind) if kind in LEAVES else 99)
    p = np.asarray(tk.default_params()) * (1 + 0.1 * rng.random(tk.n_params))
    assert _mat_bytes({"kern": TM.kern_to_struct(tk, p)}) == \
        _mat_bytes({"kern": JM.kern_to_struct(jk, p)})
    sio.savemat(tmp_path / "j.mat", {"kern": JM.kern_to_struct(jk, p)})
    sio.savemat(tmp_path / "t.mat", {"kern": TM.kern_to_struct(tk, p)})
    X = rng.standard_normal((7, 3))
    K_ref = np.asarray(jk.compute(jnp.asarray(p), jnp.asarray(X), jnp.asarray(X)))
    for f in ("j.mat", "t.mat"):
        s = sio.loadmat(tmp_path / f, squeeze_me=False)["kern"]
        k2, p2 = TM.kern_from_struct(s)
        jk2, jp2 = JM.kern_from_struct(s)
        assert k2.kind == jk2.kind == kind and k2.n_params == tk.n_params
        np.testing.assert_allclose(p2, jp2, rtol=0, atol=0)
        np.testing.assert_allclose(p2, p, rtol=1e-12)
        Kt = k2.compute(torch.as_tensor(p2), torch.as_tensor(X), torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(Kt, K_ref, rtol=1e-12, atol=1e-14)


NOISES = [("gaussian", 2, [0.25, -0.5, 0.01], None),
          ("probit", 1, [0.43], None),
          ("ncnm", 1, [0.1, 0.3], {"split_gamma": False}),
          ("ncnm", 1, [0.1, 0.3, 0.6], {"split_gamma": True}),
          ("ordered", 1, [0.2, 1.5, 0.7], {"num_categories": 4}),
          ("scale", 2, [0.1, -0.2, 1.5, 2.5], None)]


@pytest.mark.parametrize("ntype,D,params,extra", NOISES,
                         ids=[f"{n[0]}{i}" for i, n in enumerate(NOISES)])
def test_noise_struct_both_ways(ntype, D, params, extra, tmp_path):
    t = TM.noise_to_struct(ntype, params, D, 17, extra)
    assert _mat_bytes({"noise": t}) == \
        _mat_bytes({"noise": JM.noise_to_struct(ntype, params, D, 17, extra)})
    sio.savemat(tmp_path / "n.mat", {"noise": t})
    s = sio.loadmat(tmp_path / "n.mat", squeeze_me=False)["noise"]
    got, ref = TM.noise_from_struct(s), JM.noise_from_struct(s)
    assert got[0] == ref[0] == ntype and got[2] == ref[2] == (extra or {})
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[1], params)


def test_noise_struct_named_fields_and_probit_sigma2(tmp_path):
    """GPmat's own noise structs carry named fields and no `params`; the
    probit struct's sigma2 is the fixed member, not the last bias."""
    path = tmp_path / "n.mat"
    for ntype, fields, want in (("gaussian", {"bias": np.array([[0.25, -0.5]]), "sigma2": 0.01},
                                 [0.25, -0.5, 0.01]),
                                ("probit", {"bias": np.array([[0.125]]), "sigma2": 1e-6},
                                 [0.125])):
        sio.savemat(path, {"noise": dict(type=ntype, numProcess=1.0, numData=5.0,
                                         nParams=float(len(want)), **fields)})
        s = sio.loadmat(path, squeeze_me=False)["noise"]
        assert TM.noise_from_struct(s)[0] == ntype
        np.testing.assert_array_equal(TM.noise_from_struct(s)[1], want)
    sio.savemat(path, {"noise": dict(type="ncnm", numProcess=1.0, bias=np.array([[0.1]]))})
    with pytest.raises(ValueError, match="no params vector"):
        TM.noise_from_struct(sio.loadmat(path, squeeze_me=False)["noise"])
    assert TM.noise_to_struct("probit", [0.43], 1, 5)["sigma2"] == 1e-6


def _data(N=40, q=2):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, q))
    return X, np.sin(X[:, :1]) + 0.05 * rng.standard_normal((N, 1))


APPROXES = [("ftc", {}), ("dtc", {}), ("dtcvar", {}), ("fitc", {}),
            ("pitc", {"inducing_fixed": True, "pitc_block": 6})]


def _models(approx, kw):
    """A gpc_tpu GP after 3 SCG iterations and the port's copy of it."""
    X, y = _data()
    q = X.shape[1]
    kern = GK.Cmpnd(input_dim=q, components=(GK.Rbf(input_dim=q), GK.Bias(input_dim=q),
                                             GK.White(input_dim=q)))
    sparse = approx != "ftc"
    jm = JGP(kern, X, y, approx=approx, num_active=8 if sparse else 0, centre=True, seed=3,
             **kw)
    jm.optimise(iters=3)
    pm = from_jax(kern, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales,
                  approx=approx, num_active=8 if sparse else 0,
                  pitc_block=kw.get("pitc_block", 0), inducing_fixed=kw.get("inducing_fixed",
                                                                             False),
                  X_u_fixed=getattr(jm, "X_u_fixed", None), device="cpu")
    return jm, pm, X, y


@pytest.mark.parametrize("approx,kw", APPROXES, ids=[a for a, _ in APPROXES])
def test_gp_mat_files_both_ways(approx, kw, tmp_path):
    jm, pm, X, y = _models(approx, kw)
    JM.write_gp_mat(tmp_path / "j.mat", jm, X=X, y=y)
    TM.write_gp_mat(tmp_path / "t.mat", pm, X=X, y=y)
    t, j = (sio.loadmat(tmp_path / f, squeeze_me=False) for f in ("t.mat", "j.mat"))
    names = sorted(k for k in j if not k.startswith("__"))
    assert sorted(k for k in t if not k.startswith("__")) == names
    for k in names:
        _same_mat(t[k], j[k])
    gi = sio.loadmat(tmp_path / "t.mat", squeeze_me=True)["gpInfo"]
    assert str(gi["approx"]) == approx and int(gi["fixInducing"]) == int(
        kw.get("inducing_fixed", False)) and int(gi["pitcBlock"]) == kw.get("pitc_block", 0)
    want = float(jm.log_likelihood())
    back = TM.read_gp_mat(tmp_path / "j.mat", device="cpu")          # gpc_tpu's file
    assert back.spec.approx == approx and back.device.type == "cpu"
    np.testing.assert_allclose(back.log_likelihood(), want, rtol=1e-10)
    np.testing.assert_array_equal(back.theta, np.asarray(jm.theta))
    jback = JM.read_gp_mat(tmp_path / "t.mat")                         # the port's
    np.testing.assert_allclose(float(jback.log_likelihood()), want, rtol=1e-10)
    mu, var = back.predict(X[:5])
    jmu, jvar = jm.predict(X[:5])
    np.testing.assert_allclose(mu, np.asarray(jmu), rtol=1e-10)
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=1e-10)


def test_read_gp_mat_refuses_a_data_free_file_and_wants_the_card(tmp_path, monkeypatch):
    jm, pm, X, y = _models("dtc", {})
    TM.write_gp_mat(tmp_path / "nodata.mat", pm)
    with pytest.raises(ValueError, match="carries no X/y"):
        TM.read_gp_mat(tmp_path / "nodata.mat", device="cpu")
    back = TM.read_gp_mat(tmp_path / "nodata.mat", X=X, y=y, device="cpu")
    np.testing.assert_allclose(back.log_likelihood(), pm.log_likelihood(), rtol=1e-12)
    from gpc_tpu_torch import NoDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        TM.read_gp_mat(tmp_path / "nodata.mat", X=X, y=y)


# ------------------------------------------------------------------ -f 1 --


@pytest.fixture
def matdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    X, y = _data(N=50)
    sio.savemat("d.mat", {"X": X, "y": y})
    sio.savemat("v.mat", {"X": X, "y": y.ravel()})          # a 1-D y
    write_svml("d.svml", X, y)
    sio.savemat("noy.mat", {"X": X})
    with open("text.mat", "w") as f:
        f.write("not a mat file\n")
    return tmp_path


def test_load_data_format_1(matdir):
    """gpc_tpu's arrays; a 1-D y, which loadmat returns as one row, is one
    target a row (gpc_tpu keeps the row)."""
    X, y = TC.load_data("d.mat", 1)
    Xj, yj = JC.load_data("d.mat", 1)
    assert y.shape == (50, 1)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    Xs, ys = TC.load_data("d.svml", 0)
    np.testing.assert_array_equal(X, Xs)
    np.testing.assert_array_equal(y, ys)
    Xv, yv = TC.load_data("v.mat", 1)
    np.testing.assert_array_equal(Xv, Xs)
    np.testing.assert_array_equal(yv, ys)
    assert JC.load_data("v.mat", 1)[1].shape == (1, 50)


@pytest.mark.parametrize("path,fmt", [("text.mat", 1), ("noy.mat", 1), ("missing.mat", 1),
                                      ("d.mat", 2)])
def test_load_data_errors_are_gpc_tpu_s(matdir, path, fmt):
    msgs = []
    for load in (TC.load_data, JC.load_data):
        with pytest.raises(SystemExit) as exc:
            load(path, fmt)
        msgs.append(str(exc.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("Error: ")


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _same(port, ref, rtol):
    assert _NUM.sub("#", port) == _NUM.sub("#", ref)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(port)],
                               [float(v) for v in _NUM.findall(ref)], rtol=rtol)


def _body(path):
    """A model file without its comment line (it names the process)."""
    return "".join(ln for ln in open(path) if not ln.startswith("#"))


TOOLS = {
    "gp": (port_gp.main, jax_gp.main, ["-s", "1", "learn", "-#", "5"], 1e-8),
    "ivm": (port_ivm.main, jax_ivm.main,
            ["-s", "1", "learn", "-k", "rbf", "-a", "10", "-#", "3", "-n", "2", "-e", "1"], 1e-8),
    "gplvm": (port_gplvm.main, jax_gplvm.main, ["-s", "1", "learn", "-#", "4"], 1e-8),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_cli_format_1_matches_format_0_and_gpc_tpu(matdir, capsys, tool):
    port, ref, argv, rtol = TOOLS[tool]
    if tool == "ivm":       # classification labels
        X, y = _data(N=50)
        sio.savemat("d.mat", {"X": X, "y": np.sign(y)})
        write_svml("d.svml", X, np.sign(y))
    out1 = _run(port, CPU + argv + ["-f", "1", "d.mat", "m1"], capsys)
    out0 = _run(port, CPU + argv + ["d.svml", "m0"], capsys)
    assert out1 == out0
    assert _body("m1") == _body("m0")
    outj = _run(ref, argv + ["-f", "1", "d.mat", "mj"], capsys)
    _same(out1, outj, rtol)
    _same(_body("m1"), _body("mj"), rtol)


def test_gp_sparse_learn_reads_format_1(matdir, capsys):
    """learn -A dtc -a 8 -f 1 (only learn takes -f, in both packages):
    gpc_tpu's output and model file (1e-8)."""
    argv = ["-s", "2", "learn", "-A", "dtc", "-a", "8", "-#", "3", "-f", "1", "d.mat"]
    port = _run(port_gp.main, CPU + argv + ["s_port"], capsys)
    ref = _run(jax_gp.main, argv + ["s_jax"], capsys)
    _same(port, ref, 1e-8)
    _same(_body("s_port"), _body("s_jax"), 1e-8)


def test_read_gp_mat_gives_row_major_device_data(tmp_path):
    """loadmat's arrays are column-major; the model's device tensors must be
    row-major, since the card's kernels take only contiguous operands (a
    fault the card found: K1 refused read_gp_mat's X)."""
    jm, pm, X, y = _models("dtc", {})
    TM.write_gp_mat(tmp_path / "t.mat", pm, X=X, y=y)
    assert not np.asarray(sio.loadmat(tmp_path / "t.mat")["X"]).flags.c_contiguous
    back = TM.read_gp_mat(tmp_path / "t.mat", device="cpu")
    assert back.Xd.is_contiguous() and back.yd.is_contiguous()
    model = from_jax(jm.spec.kern, np.asarray(jm.theta), np.asfortranarray(X),
                     np.asfortranarray(y), jm.bias, jm.fixed_scales, approx="dtc",
                     num_active=8, device="cpu")
    assert model.Xd.is_contiguous() and model._args()[0].is_contiguous()
