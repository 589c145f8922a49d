"""The data mesh of the distributed layer (counterpart of
gpc_tpu/parallel/mesh.py).

gpc_tpu runs one process over many devices and shards arrays over a 1-D
jax Mesh on the axis "dp".  The port runs one process per device, so its
mesh is a small object: the process group, this process's rank, the world
size and the device.  Rows are sharded in equal blocks, rank r holding
block r of an array padded to a multiple of the world size (`pad_rows`);
the padding sits on the last ranks.

`mesh_2d(n_mp, n_dp)` is the 2-D mesh of the sparse path
(parallel/dist_sparse2d.py): the world as an (n_mp, n_dp) grid, rank
g = i_mp·n_dp + i_dp as jax's `reshape(n_mp, n_dp)` lays the devices out,
with one process group per mp column and per dp row.

Every collective of the distributed layer goes through the wrappers here
(`gather_rows`, `all_reduce_sum`, `broadcast_from`), which count what they
run in `COLLECTIVES` ({op: {"count", "bytes"}}, bytes of each call's
output), as ops/cuda_lib.LAUNCHES counts kernel launches; scaling_bench.py
reads it.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from gpc_tpu_torch import as_tensor, resolve_device

DATA_AXIS = "dp"
MP_AXIS = "mp"
DP_AXIS = DATA_AXIS

COLLECTIVES: dict = collections.defaultdict(lambda: {"count": 0, "bytes": 0})


def _count(op: str, t: torch.Tensor):
    ent = COLLECTIVES[op]
    ent["count"] += 1
    ent["bytes"] += t.numel() * t.element_size()


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

    def global_rank(self, r: int) -> int:
        """The default group's rank of this mesh's rank r."""
        return r if self.group is None else dist.get_global_rank(self.group, r)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One process's view of the (mp, dp) mesh: each axis a 1-D Mesh over
    its own process group (mp: the ranks of this dp index, dp: the ranks of
    this mp index), both on `device`."""

    mp: Mesh
    dp: Mesh
    device: torch.device


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


def mesh_2d(n_mp: int, n_dp: int, device=None) -> Mesh2D:
    """The (n_mp, n_dp) mesh of the initialised default group (world size
    n_mp·n_dp).  Every rank creates every group, mp groups first, in the
    same order, as torch.distributed requires; `device` as in data_mesh."""
    if not dist.is_initialized():
        raise RuntimeError("mesh_2d: no process group; call "
                           "parallel.multihost.initialize_from_env() or "
                           "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_mp * n_dp:
        raise ValueError(f"mesh_2d: {n_mp} x {n_dp} ranks, world size {world}")
    i_mp, i_dp = divmod(rank, n_dp)
    mp_groups = [dist.new_group([i * n_dp + j for i in range(n_mp)]) for j in range(n_dp)]
    dp_groups = [dist.new_group([i * n_dp + j for j in range(n_dp)]) for i in range(n_mp)]
    dev = data_mesh(device).device
    return Mesh2D(mp=Mesh(group=mp_groups[i_dp], rank=i_mp, size=n_mp, device=dev,
                          axis=MP_AXIS),
                  dp=Mesh(group=dp_groups[i_mp], rank=i_dp, size=n_dp, device=dev,
                          axis=DP_AXIS),
                  device=dev)


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
    out = torch.cat(parts, dim=0)
    _count("all-gather", out)
    return out


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Σ over the mesh's ranks of `x`, on every rank (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    _count("all-reduce", out)
    return out


def broadcast_from(mesh: Mesh, x: torch.Tensor, src: int) -> torch.Tensor:
    """Rank src's `x` on every rank (a new tensor; equal shapes)."""
    out = x.contiguous().clone()
    dist.broadcast(out, src=mesh.global_rank(src), group=mesh.group)
    _count("broadcast", out)
    return out


def replicated(mesh: Mesh, arr) -> torch.Tensor:
    """The whole array on the mesh's device, in its working dtype."""
    return as_tensor(np.asarray(arr), mesh.device)
