"""The data mesh of the distributed layer (counterpart of
gpc_tpu/parallel/mesh.py).

gpc_tpu runs one process over many devices and shards arrays over a 1-D
jax Mesh on the axis "dp".  The port runs one process per device, so its
mesh is a small object: the process group, this process's rank, the world
size and the device.  Rows are sharded in equal blocks, rank r holding
block r of an array padded to a multiple of the world size (`pad_rows`);
the padding sits on the last ranks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from gpc_tpu_torch import as_tensor, resolve_device

DATA_AXIS = "dp"


def backend_for(device) -> str:
    """The process group's backend for `device`: NCCL on CUDA, gloo on the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of the 1-D data mesh."""

    group: object          # torch.distributed ProcessGroup (None: the default group)
    rank: int
    size: int
    device: torch.device
    axis: str = DATA_AXIS


def data_mesh(device=None, group=None) -> Mesh:
    """The mesh of the initialised process group (`group`, or the default
    one) on `device`: None means this rank's card (cuda:rank modulo the
    cards), and raises without one; "cpu" for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh: no process group; call "
                           "parallel.multihost.initialize_from_env() or "
                           "torch.distributed.init_process_group first")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group=group, rank=rank, size=size, device=dev)


def pad_rows(arr, multiple: int):
    """Pad axis 0 to a multiple (sharding needs equal blocks); returns
    (padded, n_valid)."""
    n = arr.shape[0]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return arr, n
    pad = np.zeros((target - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


def shard_rows(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's row block of a padded array, on the mesh's device in its
    working dtype."""
    arr = np.asarray(arr)
    if arr.shape[0] % mesh.size:
        raise ValueError(f"shard_rows: {arr.shape[0]} rows do not split over "
                         f"{mesh.size} ranks; pad_rows first")
    b = arr.shape[0] // mesh.size
    return as_tensor(arr[mesh.rank * b:(mesh.rank + 1) * b], mesh.device)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's row block of `x`, concatenated in rank order, on every
    rank (equal blocks)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


def replicated(mesh: Mesh, arr) -> torch.Tensor:
    """The whole array on the mesh's device, in its working dtype."""
    return as_tensor(np.asarray(arr), mesh.device)
