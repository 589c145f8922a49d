"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` files compile with nvcc for sm_90a (one nvcc process per
source, in parallel) and link into ONE shared library with a plain C
interface, loaded by ctypes.  The build runs at first use,
into `gpc_tpu_torch/_build/`, from the sources in the checkout only; the
library's file name carries a hash of the sources, so an edited source is
never served by a stale build.

Every C entry point launches on the stream it is given (K3's,
`gpc_panel_state`, forks two streams of its own from it and joins them back
before it returns) and returns the first CUDA error; `launch` raises on a
non-zero code and adds one to the kernel's count in `LAUNCHES`, which a run
reads to show that its path went through the kernels.  A launch captured
in a CUDA graph runs at each replay without its wrapper: the code that
replays the graph counts it (models/ivm.Selector).  `gpc_panel_state`
also counts each kernel it launches, by kind, into an array the caller
passes (ops/chol_panel.py adds those counts to `LAUNCHES`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# launches per kernel name, counted by `launch`
LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gpc_dist_gram": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "gpc_inner_gram": [_P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P],
    "gpc_dist_gram_batched": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "gpc_inner_gram_batched": [_I, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P],
    "gpc_chol_blocked": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P],
    "gpc_panel_state": [_P, _P, _I, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P,
                        _P, _I, _P, _I, _P, _P],
    "gpc_panel_corr": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    "gpc_mega_grid": [],
    "gpc_evidence_mega": [_P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P],
    "gpc_probe_grid": [],
    "gpc_overlap_probe": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    "gpc_dma_probe": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "gpc_leaf_parts": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "gpc_dot_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gpc_vpu_exp": [_P, _P, _I, _I, _P],
    "gpc_vpu_gram": [_P, _P, _P, _I, _I, _P],
    "gpc_vpu_matvec_cluster": [_I],
    "gpc_vpu_matvec_home": [_I, _I],
    "gpc_vpu_matvec": [_P, _P, _P, _I, _I, _I, _P],
    "gpc_vpu_store_layout": [_P],
    "gpc_vpu_store": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None   # wall time of this process's build (None: not built)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(ARCH.encode())
    return BUILD_DIR / f"libgpc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built: one
    nvcc per source, all started together, then one link."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{f.stem}.{tag}.o" for f in cu]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler",
                               "-fPIC", "-Xptxas=-v", "-c", "-o", str(o), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for f, o in zip(cu, objs)]
    logs = [f"== {f.name}\n{p.communicate()[0]}" for f, p in zip(cu, procs)]
    tmp = so.with_suffix(f".{tag}.tmp")
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp)]
                              + [str(o) for o in objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(count_as: str, entry: str, *args) -> None:
    """Call one C entry point; raise on a CUDA error, else count it."""
    code = getattr(library(), entry)(*args)
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code}")
    LAUNCHES[count_as] += 1


def require_cuda(name: str, *tensors: torch.Tensor):
    """Checks of a kernel wrapper: CUDA, float32, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs CUDA")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel needs float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
