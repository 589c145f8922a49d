"""Warm-process daemon for the port's gp / ivm / gplvm CLIs (counterpart of
gpc_tpu/cli/daemon.py).

A one-shot CLI of the port pays, on every call, for importing torch,
creating a CUDA context and loading the kernel library.  This daemon pays
once: it keeps one process alive behind a unix socket, and the client (the
standard library only, no torch) forwards argv and receives the command's
captured stdout and stderr when it completes (output is buffered, not
incremental).

Usage:
    python -m gpc_tpu_torch.cli.daemon run gp learn ...   # client (starts the server)
    python -m gpc_tpu_torch.cli.daemon serve              # foreground server
    python -m gpc_tpu_torch.cli.daemon stop
    python gpc_tpu_torch/cli/daemon.py run gp learn ...   # the client without torch

`-m` imports the package, and so torch, before the client runs; naming the
file instead runs the client on the standard library alone.

Each request runs the same `main(argv)` as the one-shot CLI, with sys.argv,
the working directory, torch's and numpy's global generators and the
warning registry as a fresh process has them, so the same request gives
the output and model file the one-shot CLI gives.  Every command runs on
the card unless its argv asks for `--device cpu`, as in the CLIs.  Before
the first request the server imports the three CLIs and, where there is a
card, creates the CUDA context, loads the kernel library (ops/cuda_lib.py,
built if needed) and runs one small evaluation there, so that the first
request finds cuBLAS and cuSOLVER initialised.

Protocol, as gpc_tpu's: a 4-byte big-endian length, then JSON {tool, argv,
cwd} / {rc, out, err}; both sides add "pkg": "gpc_tpu_torch" and refuse a
message without it, so a gpc_tpu daemon and this one never answer each
other.  The socket is GPC_TPU_TORCH_DAEMON_SOCKET (default
~/.cache/gpc_tpu_torch/daemon.sock; mode 0o600, its default directory
0o700).  The server exits after GPC_TPU_DAEMON_IDLE seconds (default 900)
without a request, and handles requests strictly one at a time.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import subprocess
import sys
import time

_TOOLS = ("gp", "ivm", "gplvm")
PKG = "gpc_tpu_torch"
SOCKET_ENV = "GPC_TPU_TORCH_DAEMON_SOCKET"


def sock_path() -> str:
    return os.environ.get(SOCKET_ENV, os.path.join(os.path.expanduser("~"), ".cache",
                                                   PKG, "daemon.sock"))


def _send(conn, obj):
    data = json.dumps(dict(obj, pkg=PKG)).encode()
    conn.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(conn, n):
    data = b""
    while len(data) < n:
        part = conn.recv(min(65536, n - len(data)))
        if not part:
            return None
        data += part
    return data


def _recv(conn):
    """The next message, or None when the peer hung up or is not a
    gpc_tpu_torch daemon or client."""
    hdr = _recv_exact(conn, 4)
    if hdr is None:
        return None
    data = _recv_exact(conn, struct.unpack(">I", hdr)[0])
    if data is None:
        return None
    msg = json.loads(data)
    return msg if msg.get("pkg") == PKG else None


# ---------------------------------------------------------------- server --


class _FreshProcess:
    """The process-wide state a one-shot CLI starts from, taken once before
    the first request and put back around each one."""

    def __init__(self):
        import numpy as np
        import torch
        self._np, self._torch = np, torch
        self.np_state = np.random.get_state()
        self.torch_state = torch.get_rng_state()
        self.cuda_state = torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None

    def restore(self):
        self._np.random.set_state(self.np_state)
        self._torch.set_rng_state(self.torch_state)
        if self.cuda_state is not None:
            self._torch.cuda.set_rng_state_all(self.cuda_state)


def _preload():
    """The three CLIs' mains, and the card warmed where there is one: the
    CUDA context, the kernel library (built if needed) and the libraries a
    first evaluation initialises (cuBLAS, cuSOLVER, the kernels' modules),
    through one value_and_grad of a 64-point GP."""
    import numpy as np
    import torch

    from gpc_tpu_torch.cli import gp, gplvm, ivm
    if torch.cuda.is_available():
        from gpc_tpu_torch import kernels as KM
        from gpc_tpu_torch.models.gp import GP
        from gpc_tpu_torch.ops import cuda_lib
        cuda_lib.library()
        X = np.linspace(-1.0, 1.0, 64).reshape(64, 1)
        kern = KM.Cmpnd(input_dim=1, components=(KM.Rbf(input_dim=1), KM.White(input_dim=1)))
        model = GP(kern, X, np.sin(X))
        model.value_and_grad_fn()(model.theta)
        torch.cuda.synchronize()
    return {"gp": gp, "ivm": ivm, "gplvm": gplvm}


def _handle(modules, fresh, req):
    import warnings

    tool = req.get("tool")
    argv = [str(a) for a in req.get("argv", [])]
    if tool not in _TOOLS:
        return {"rc": 2, "out": "", "err": f"unknown tool {tool!r}\n"}
    out, err = io.StringIO(), io.StringIO()
    rc = 0
    prev = (os.getcwd(), sys.stdout, sys.stderr, sys.argv)
    try:
        if req.get("cwd"):
            os.chdir(req["cwd"])
        fresh.restore()
        # the model files' "Run as:" comment reads sys.argv, as one-shot
        sys.argv = [modules[tool].__file__] + argv
        sys.stdout, sys.stderr = out, err
        with warnings.catch_warnings():    # warnings show as in a fresh process
            modules[tool].main(argv)
    except SystemExit as e:     # ExitError and sys.exit
        if isinstance(e.code, str):
            err.write(e.code + "\n")
            rc = 1
        else:
            rc = int(e.code or 0)
    except Exception as e:  # noqa: BLE001 - the daemon outlives any request
        import traceback
        err.write("".join(traceback.format_exception(e)))
        rc = 1
    finally:
        os.chdir(prev[0])
        sys.stdout, sys.stderr, sys.argv = prev[1], prev[2], prev[3]
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def _answering(path) -> bool:
    """Whether a server answers at `path` (a short-timeout probe)."""
    probe = socket.socket(socket.AF_UNIX)
    probe.settimeout(2.0)
    try:
        probe.connect(path)
        return True
    except OSError:
        return False
    finally:
        probe.close()


def serve() -> int:
    path = sock_path()
    # requests run with caller-given paths, so the socket is private: a
    # 0o600 socket in a 0o700 directory (Linux checks connect() against the
    # file mode); only the default directory is chmodded, a user's socket
    # may sit in a shared one
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    if SOCKET_ENV not in os.environ:
        os.chmod(os.path.dirname(path), 0o700)
    if os.path.exists(path):
        if _answering(path):
            print(f"daemon already running at {path}", file=sys.stderr)
            return 0
        os.unlink(path)          # a stale socket: nothing answers
    modules = _preload()
    fresh = _FreshProcess()
    idle = float(os.environ.get("GPC_TPU_DAEMON_IDLE", "900"))
    srv = socket.socket(socket.AF_UNIX)
    old_umask = os.umask(0o077)  # no wider window before the chmod
    try:
        srv.bind(path)
    finally:
        os.umask(old_umask)
    os.chmod(path, 0o600)
    srv.listen(1)
    srv.settimeout(idle)
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                break            # idle shutdown
            with conn:
                conn.settimeout(None)
                req = _recv(conn)
                if req is None:
                    continue
                if req.get("tool") == "__stop__":
                    _send(conn, {"rc": 0, "out": "", "err": ""})
                    break
                _send(conn, _handle(modules, fresh, req))
    finally:
        srv.close()
        if os.path.exists(path):
            os.unlink(path)
    return 0


# ---------------------------------------------------------------- client --


def _connect(path, spawn=True, wait_s=300.0):
    """A connected socket, starting a server first when `spawn` and none
    answers; None when none answers within `wait_s`."""
    cli = socket.socket(socket.AF_UNIX)
    try:
        cli.connect(path)
        return cli
    except OSError:
        cli.close()
        if not spawn:
            return None
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    log = os.path.join(os.path.dirname(path), "daemon.log")
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    with open(log, "ab") as lf:
        subprocess.Popen([sys.executable, "-m", "gpc_tpu_torch.cli.daemon", "serve"],
                         stdout=lf, stderr=lf, stdin=subprocess.DEVNULL, env=env,
                         start_new_session=True)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        cli = socket.socket(socket.AF_UNIX)
        try:
            cli.connect(path)
            return cli
        except OSError:
            cli.close()
            time.sleep(0.1)
    return None


def client_run(tool, argv, timeout=None) -> int:
    """Run `tool argv` in the daemon (started if none answers); prints its
    output and returns its exit code.  `timeout` bounds the wait for the
    answer (None: no bound)."""
    path = sock_path()
    cli = _connect(path)
    if cli is None:
        print(f"Error: could not start the gpc_tpu_torch daemon "
              f"(see {os.path.dirname(path)}/daemon.log)", file=sys.stderr)
        return 3
    with cli:
        cli.settimeout(timeout)
        _send(cli, {"tool": tool, "argv": list(argv), "cwd": os.getcwd()})
        resp = _recv(cli)
    if resp is None:
        print("Error: the gpc_tpu_torch daemon hung up", file=sys.stderr)
        return 3
    sys.stdout.write(resp["out"])
    sys.stderr.write(resp["err"])
    return resp["rc"]


def stop(timeout=30.0) -> int:
    """Stop the daemon if one answers."""
    cli = _connect(sock_path(), spawn=False)
    if cli is None:
        return 0
    with cli:
        cli.settimeout(timeout)
        _send(cli, {"tool": "__stop__"})
        _recv(cli)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return serve()
    if cmd == "stop":
        return stop()
    if cmd == "run":
        if not rest or rest[0] not in _TOOLS:
            print(f"usage: daemon run {{{'|'.join(_TOOLS)}}} args...", file=sys.stderr)
            return 2
        return client_run(rest[0], rest[1:])
    print(f"unknown daemon command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
