"""Build the port's native C++ host helpers at first use.

Counterpart of gpc_tpu/native/build.py, with one difference: a library is
built into `gpc_tpu_torch/_build/` (never next to its source) under a name
that carries the source's hash, `lib<name>_<hash>.so`, so a changed source
is rebuilt and concurrent builds never expose a half-written file.  These
are host helpers, not device kernels (those are nvcc's, ops/cuda_lib.py).
`load` returns None where no C++ compiler can build the library; each
caller then takes its pure-Python version and counts that it did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = {"svml": "svml_reader.cpp", "lbfgs": "lbfgs.cpp"}
_LOCK = threading.Lock()
_CACHE: dict = {}


def library_path(name: str) -> Path:
    """The shared library of helper `name`, compiled with
    `g++ -O3 -shared -fPIC` unless a build of this very source exists."""
    src = _DIR / SOURCES[name]
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def load(name: str):
    """The loaded ctypes library of helper `name`, or None when it cannot be
    built here; the first outcome is kept for the process."""
    with _LOCK:
        if name not in _CACHE:
            try:
                _CACHE[name] = ctypes.CDLL(str(library_path(name)))
            except (OSError, subprocess.CalledProcessError):
                _CACHE[name] = None
        return _CACHE[name]
