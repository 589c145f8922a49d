"""The port's SVM-light readers: the native reader (native/svml_reader.cpp,
built by native/build.py), the pure-Python reader and gpc_tpu's reader give
the same arrays, bit for bit, on files written here: comments (`2:3#c`
included), CR line ends, no trailing newline, empty and blank lines, sparse
and unordered indices, exponents, and a file whose size is a whole number
of pages (the reader's end-of-file guard).  `read_svml` counts which reader
ran; the libraries build into gpc_tpu_torch/_build/, L-BFGS's through the
same helper."""

import importlib
import mmap

import numpy as np
import pytest

from gpc_tpu.io import svml as JS
from gpc_tpu_torch.io import svml as TS
from gpc_tpu_torch.native import build, svml_native

TL = importlib.import_module("gpc_tpu_torch.optim.lbfgs")

FILES = {
    "plain": "1 1:0.5 2:-1.25\n-1 1:2 2:3e-2\n0.5 2:7\n",
    "comments": "# header line\n1 1:0.5 2:3#c\n2 1:1 # trailing comment\n#\n-3 3:4.5e1#x\n",
    "crlf": "1 1:0.5 2:1\r\n2 2:2\r\n\r\n-1 1:-3\r\n",
    "no_trailing_newline": "1 1:0.5 2:1\n2 3:0.25",
    "blank_lines": "\n\n1 1:1\n   \n\t\n2 2:2\n\n",
    "sparse_unordered": "1 7:1.5 2:-2 5:3\n-1 3:1\n2 10:1e-3 1:4\n0\n",
}


def _write(path, text):
    path.write_bytes(text.encode())
    return path


def _page_multiple(tmp_path):
    """A file of exactly one page that ends mid-number."""
    page = mmap.PAGESIZE
    head = "1 1:0.5 2:1\n"
    body = head * ((page - 20) // len(head))
    tail = "3 1:" + "1" * (page - len(body) - 4)
    text = body + tail
    assert len(text) == page
    return _write(tmp_path / "page.svml", text)


@pytest.fixture(params=sorted(FILES) + ["page_multiple"])
def svml_file(request, tmp_path):
    if request.param == "page_multiple":
        return _page_multiple(tmp_path)
    return _write(tmp_path / f"{request.param}.svml", FILES[request.param])


def test_native_python_and_gpc_tpu_readers_agree(svml_file):
    native = svml_native.read(svml_file)
    assert native is not None
    py = TS.read_svml_py(svml_file)
    ref = JS.read_svml_py(svml_file)
    for a, b, c in zip(native, py, ref):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_read_svml_takes_the_native_reader_and_counts_it(tmp_path):
    f = _write(tmp_path / "a.svml", FILES["comments"])
    before = dict(TS.READS)
    X, y = TS.read_svml(f)
    assert TS.READS["native"] == before.get("native", 0) + 1
    assert TS.READS["python"] == before.get("python", 0)
    assert X.shape == (3, 3) and y.shape == (3, 1)
    np.testing.assert_array_equal(X[0], [0.5, 3.0, 0.0])


def test_read_svml_falls_back_to_python_and_counts_it(tmp_path, monkeypatch):
    """Without a C++ compiler the Python reader reads the file, as in
    gpc_tpu; the count says so."""
    f = _write(tmp_path / "a.svml", FILES["sparse_unordered"])
    monkeypatch.setattr(svml_native, "load", lambda name: None)
    before = TS.READS["python"]
    X, y = TS.read_svml(f)
    assert TS.READS["python"] == before + 1
    np.testing.assert_array_equal(X, JS.read_svml_py(f)[0])


def test_empty_and_missing_files(tmp_path):
    empty = _write(tmp_path / "empty.svml", "")
    X, y = TS.read_svml(empty)          # the native reader cannot map it
    assert X.shape == (0, 0) and y.shape == (0, 1)
    with pytest.raises(FileNotFoundError):
        TS.read_svml(tmp_path / "missing.svml")


def test_write_then_read_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((50, 4))
    X[rng.random((50, 4)) < 0.3] = 0.0
    X[:, -1] = 1.0                      # the last feature present on every row
    y = rng.standard_normal((50, 1))
    TS.write_svml(tmp_path / "w.svml", X, y)
    Xr, yr = TS.read_svml(tmp_path / "w.svml")
    np.testing.assert_array_equal(Xr, X)
    np.testing.assert_array_equal(yr, y)


@pytest.mark.parametrize("name", ["svml", "lbfgs"])
def test_native_libraries_build_into_the_build_dir(name):
    so = build.library_path(name)
    assert so.parent == build.BUILD_DIR
    assert so.parent.name == "_build" and so.parent.parent.name == "gpc_tpu_torch"
    assert so.name.startswith(f"lib{name}_") and so.exists()
    assert build.load(name) is not None


def test_lbfgs_loads_through_the_shared_helper():
    assert TL.native_lib() is build.load("lbfgs")
