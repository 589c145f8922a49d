"""Process-group entry from the environment and host-sharded data loading
(counterpart of gpc_tpu/parallel/multihost.py).

* `initialize_from_env()` starts the torch.distributed process group from
  the variables gpc_tpu reads, so the same command works on every host:
      GPC_TPU_COORDINATOR=host0:8476 GPC_TPU_NUM_PROCS=4 GPC_TPU_PROC_ID=$i
  (NCCL on the card, gloo on the CPU; the coordinator may also be a URL
  such as file:///shared/store); without them it does nothing.
* `load_svml_sharded(path, mesh)` streams an SVM-light file twice and
  parses only this rank's row block: no process holds every row.
"""

from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from gpc_tpu_torch import resolve_device
from gpc_tpu_torch.io.svml import clean_line, parse_lines
from gpc_tpu_torch.parallel.mesh import backend_for, data_mesh


def initialize_from_env(device=None) -> bool:
    """Start the process group if GPC_TPU_COORDINATOR / GPC_TPU_NUM_PROCS /
    GPC_TPU_PROC_ID ask for one; returns True when a group of more than one
    process is (now) active.  Safe to call again and in single-process runs.
    `device` (None: the card; "cpu") picks the backend."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("GPC_TPU_COORDINATOR")
    nproc = os.environ.get("GPC_TPU_NUM_PROCS")
    if coord is None and nproc is None:
        return False
    if coord is None or nproc is None:
        raise ValueError("initialize_from_env: set both GPC_TPU_COORDINATOR and "
                         "GPC_TPU_NUM_PROCS (and GPC_TPU_PROC_ID on each process)")
    # host:port as gpc_tpu takes it; a URL (file://...) is passed as it is
    init = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend_for(resolve_device(device)),
                            init_method=init, world_size=int(nproc),
                            rank=int(os.environ.get("GPC_TPU_PROC_ID", "0")))
    return dist.get_world_size() > 1


def process_row_range(n_rows: int, mesh=None):
    """Rows [lo, hi) of this rank under equal row blocks of `n_rows`
    (already padded to a multiple of the world size)."""
    size = mesh.size if mesh is not None else dist.get_world_size()
    rank = mesh.rank if mesh is not None else dist.get_rank()
    if n_rows % size:
        raise ValueError("process_row_range: pad rows to a multiple of the world size first")
    block = n_rows // size
    return rank * block, (rank + 1) * block


def load_svml_sharded(path, mesh=None):
    """This rank's row block of an SVM-light file, padded with zero rows to
    a multiple of the world size (the padding on the last ranks).

    Returns (X_local, y_local, n_valid) as float64 numpy arrays and the true
    row count; the feature count is the whole file's largest index.  Lines
    are cleaned exactly as io/svml.read_svml_py cleans them."""
    if mesh is None:
        mesh = data_mesh()
    # pass 1 (streaming): the row count and the feature count
    n_valid = 0
    input_dim = 0
    with open(path) as f:
        for ln in f:
            ln = clean_line(ln)
            if not ln:
                continue
            n_valid += 1
            for tok in ln.split()[1:]:
                input_dim = max(input_dim, int(tok.split(":")[0]))
    n_pad = -(-n_valid // mesh.size) * mesh.size
    lo, hi = process_row_range(n_pad, mesh)
    lo_v, hi_v = min(lo, n_valid), min(hi, n_valid)
    # pass 2 (streaming): keep only this rank's lines
    lines = []
    row = 0
    with open(path) as f:
        for ln in f:
            if row >= hi_v:
                break
            ln = clean_line(ln)
            if not ln:
                continue
            if row >= lo_v:
                lines.append(ln)
            row += 1
    X, y = parse_lines(lines, input_dim)
    extra = (hi - lo) - X.shape[0]
    if extra:
        X = np.concatenate([X, np.zeros((extra, input_dim))], axis=0)
        y = np.concatenate([y, np.zeros((extra, 1))], axis=0)
    return X, y, n_valid
