"""The port's warm-process daemon (gpc_tpu_torch/cli/daemon.py).

A server runs in a subprocess on a socket under tmp_path with a short idle
time; every wait has its own time limit (socket timeouts, subprocess
timeouts).  Through the client, gp learn and log-likelihood give the
one-shot CLI's output and model file byte for byte, twice in a row (the
daemon puts back the state a fresh process starts from); an error request
leaves the server serving; a gpc_tpu-style request without the port's tag
is refused; `stop` ends the server; a stale socket file (nothing listening)
is replaced by a new server."""

import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from gpc_tpu_torch.cli import daemon
from gpc_tpu_torch.io.svml import write_svml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
WAIT_S = 60.0


def _env(sock):
    env = dict(os.environ)
    env.update({daemon.SOCKET_ENV: str(sock), "GPC_TPU_DAEMON_IDLE": "120",
                "PYTHONPATH": os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)})
    return env


def _wait_for_socket(path, proc=None, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"daemon exited early with {proc.returncode}")
        if daemon._answering(str(path)):
            return
        time.sleep(0.1)
    raise AssertionError("daemon did not come up in time")


@pytest.fixture
def served(tmp_path, monkeypatch):
    """(tmp_path, server process) with the data file written there."""
    sock = tmp_path / "d.sock"
    monkeypatch.setenv(daemon.SOCKET_ENV, str(sock))
    monkeypatch.setenv("GPC_TPU_DAEMON_IDLE", "120")
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((40, 2))
    write_svml("train.svml", X, np.sin(X[:, :1]) + 0.05 * rng.standard_normal((40, 1)))
    with open(tmp_path / "server.log", "wb") as log:
        proc = subprocess.Popen([sys.executable, "-m", "gpc_tpu_torch.cli.daemon", "serve"],
                                env=_env(sock), stdout=log, stderr=log,
                                stdin=subprocess.DEVNULL, cwd=tmp_path)
    try:
        _wait_for_socket(sock, proc)
        yield tmp_path, proc
    finally:
        daemon.stop(timeout=WAIT_S)
        try:
            proc.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=WAIT_S)


def _oneshot(tool, argv, cwd, sock):
    res = subprocess.run([sys.executable, "-m", f"gpc_tpu_torch.cli.{tool}"] + argv,
                         env=_env(sock), cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    return res.returncode, res.stdout, res.stderr


def test_requests_match_the_oneshot_cli(served, capsys):
    tmp, proc = served
    learn = CPU + ["-s", "17", "learn", "-#", "5", "train.svml"]
    rc, out_ref, err_ref = _oneshot("gp", learn + ["m_oneshot"], tmp, tmp / "d.sock")
    assert rc == 0, err_ref
    outs = []
    for name in ("m_d1", "m_d2"):
        assert daemon.client_run("gp", learn + [name], timeout=300) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == out_ref
    ref = (tmp / "m_oneshot").read_bytes()
    assert ref.startswith(b"# Run as: ")
    for name in ("m_d1", "m_d2"):
        assert (tmp / name).read_bytes() == ref.replace(b"m_oneshot", name.encode())
    ll = CPU + ["log-likelihood", "train.svml", "m_oneshot"]
    rc, out_ll, _ = _oneshot("gp", ll, tmp, tmp / "d.sock")
    assert rc == 0
    for _ in range(2):
        assert daemon.client_run("gp", ll, timeout=300) == 0
        assert capsys.readouterr().out == out_ll
    assert proc.poll() is None


def test_errors_leave_the_server_serving(served, capsys):
    tmp, proc = served
    rc = daemon.client_run("gp", CPU + ["learn", "missing.svml", "x"], timeout=120)
    got = capsys.readouterr()
    rc_ref, _, err_ref = _oneshot("gp", CPU + ["learn", "missing.svml", "x"], tmp,
                                  tmp / "d.sock")
    assert rc == rc_ref == 1
    assert got.err.strip() == err_ref.strip().splitlines()[-1]
    assert daemon.client_run("gp", CPU + ["display", "missing_model"], timeout=120) == 1
    assert "Unable to read file" in capsys.readouterr().err
    assert daemon.client_run("ivm", CPU + [], timeout=120) == 1
    assert "No command provided" in capsys.readouterr().err
    assert proc.poll() is None


def test_a_request_without_the_port_tag_is_refused(served):
    """A gpc_tpu client's message (no "pkg") gets no answer: the server hangs
    up and keeps serving."""
    tmp, proc = served
    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(WAIT_S)
        s.connect(str(tmp / "d.sock"))
        data = b'{"tool": "gp", "argv": ["display"], "cwd": "."}'
        s.sendall(struct.pack(">I", len(data)) + data)
        assert s.recv(4) == b""
    assert daemon._answering(str(tmp / "d.sock")) and proc.poll() is None


def test_stop_ends_the_server(served):
    tmp, proc = served
    assert daemon.stop(timeout=WAIT_S) == 0
    assert proc.wait(timeout=WAIT_S) == 0
    assert not (tmp / "d.sock").exists()
    assert daemon.stop(timeout=WAIT_S) == 0         # nothing to stop


def test_stale_socket_is_recovered(tmp_path, monkeypatch, capsys):
    """A socket file nothing listens on: the client starts a server, which
    replaces the file and answers."""
    sock = tmp_path / "stale.sock"
    s = socket.socket(socket.AF_UNIX)
    s.bind(str(sock))
    s.close()                       # the file stays, nothing listens
    assert sock.exists() and not daemon._answering(str(sock))
    for k, v in _env(sock).items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    try:
        rc = daemon.client_run("gp", CPU + ["display", "missing_model"], timeout=120)
        assert rc == 1 and "Unable to read file" in capsys.readouterr().err
        assert daemon._answering(str(sock))
    finally:
        daemon.stop(timeout=WAIT_S)
    deadline = time.monotonic() + WAIT_S
    while sock.exists() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not sock.exists()


def test_default_socket_is_the_port_s_own(monkeypatch):
    monkeypatch.delenv(daemon.SOCKET_ENV, raising=False)
    monkeypatch.setenv("GPC_TPU_DAEMON_SOCKET", "/elsewhere/gpc_tpu.sock")
    assert daemon.sock_path().endswith(os.path.join(".cache", "gpc_tpu_torch", "daemon.sock"))


def test_client_by_path_imports_no_torch(served):
    """`python gpc_tpu_torch/cli/daemon.py run ...` runs the client on the
    standard library alone: with torch blocked it still gets its answer."""
    tmp, proc = served
    code = ("import runpy, sys\n"
            "sys.modules['torch'] = None\n"
            f"sys.argv = [{daemon.__file__!r}, 'run', 'gp', '--device', 'cpu', 'display', "
            "'missing_model']\n"
            f"runpy.run_path({daemon.__file__!r}, run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(tmp / "d.sock"), cwd=tmp,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert "Unable to read file missing_model" in res.stderr
    assert proc.poll() is None
