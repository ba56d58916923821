"""Process groups and the sharding helpers (port of
pvnet_tpu/parallel/mesh.py, same names).

A JAX mesh is a grid of devices in one program; here a :class:`Mesh` is
this process's place in a ``torch.distributed`` group: its rank, the
group's size (the mesh's device count), its one device (``cuda:LOCAL_RANK``
or the CPU) and the group. A batch axis split over the mesh becomes each
rank's contiguous rows ``[r*b/N, (r+1)*b/N)`` of the global batch
(:func:`shard_batch`); a replicated pytree becomes a broadcast from rank 0
(:func:`replicate`). Without an initialized group :func:`make_mesh` gives
world size 1, no group, and every collective here is the identity.

The collectives use only ``all_reduce`` and ``broadcast``, which NCCL and
gloo both take for CUDA and CPU tensors; :func:`all_gather_rows` is an
``all_reduce`` of a zero-filled buffer in which each rank writes its rows.

  torchrun --nproc_per_node 4 -m pvnet_tpu_torch.train ...   # one node

:func:`init_process_group` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); ``PVNET_PG_TIMEOUT`` (seconds), where
set, bounds every collective's wait.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_ENV = "PVNET_PG_TIMEOUT"


@dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel group."""
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None       # a ProcessGroup; None: no group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b``; raises unless the
        mesh's size divides ``b`` (equal shards keep the gradient mean the
        global batch's)."""
        if b % self.size:
            raise ValueError(f"a global batch of {b} does not split over "
                             f"{self.size} ranks")
        n = b // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def _local_device(device=None) -> torch.device:
    """``device`` (default: CUDA where there is one, else the CPU); a CUDA
    device without an index is this process's, ``cuda:LOCAL_RANK``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _timeout() -> Optional[datetime.timedelta]:
    seconds = os.environ.get(TIMEOUT_ENV)
    return datetime.timedelta(seconds=float(seconds)) if seconds else None


def init_process_group(device=None, backend: Optional[str] = None) -> Mesh:
    """The process group torchrun describes, joined once, as a
    :class:`Mesh`: NCCL for a CUDA ``device`` (``cuda`` means
    ``cuda:LOCAL_RANK``), gloo for the CPU, unless ``backend`` names one.
    Outside torchrun (no RANK / WORLD_SIZE in the environment) no group
    is made and the mesh has world size 1."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return make_mesh(device)
    dev = _local_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"timeout": _timeout()} if _timeout() else {}
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", **kw)
    return make_mesh(dev)


def make_mesh(device=None, group=None) -> Mesh:
    """This process's mesh over the initialized group (``group``, or the
    whole world), or world size 1 without one.

    Like the JAX function, which refuses several processes, it refuses a
    world that spans several nodes (LOCAL_WORLD_SIZE below WORLD_SIZE)
    unless the group is given: use :func:`make_global_mesh` there."""
    dev = _local_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a group was given but no process group is "
                             "initialized")
        return Mesh(0, 1, dev, None)
    if group is None:
        world = dist.get_world_size()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local != world:
            raise NotImplementedError(
                f"make_mesh() supports one node; this world has {world} "
                f"ranks, {local} on this node. Use make_global_mesh() with "
                f"shard_batch_global() / replicate_global(), or pass the "
                f"group explicitly.")
        group = dist.group.WORLD
    return Mesh(dist.get_rank(group), dist.get_world_size(group), dev, group)


def make_global_mesh(device=None) -> Mesh:
    """The mesh over every rank of every node (JAX's ``make_global_mesh``).
    Feed it with :func:`shard_batch_global` (each process's own rows) and
    :func:`replicate_global`."""
    if not dist.is_initialized():
        return make_mesh(device)
    return Mesh(dist.get_rank(), dist.get_world_size(), _local_device(device),
                dist.group.WORLD)


def _tree_map(fn, tree):
    """``fn`` on every tensor / array leaf of dicts, lists, tuples and
    named tuples; other leaves as they are."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every leaf of a global batch (dim 0 split over
    the mesh), as tensors on its device; raises when the mesh's size does
    not divide a leaf's rows."""
    return _tree_map(lambda x: _tensor(x[mesh.rows(len(x))], mesh.device),
                     batch)


def _src(mesh: Mesh) -> int:
    return dist.get_global_rank(mesh.group, 0)


def replicate(tree, mesh: Mesh):
    """Every leaf on this rank's device with rank 0's values: tensors and
    arrays come back as tensors; a module (or its parameters and buffers)
    is overwritten in place and returned."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        if mesh.group is not None:
            with torch.no_grad():
                for t in list(tree.parameters()) + list(tree.buffers()):
                    dist.broadcast(t.data, _src(mesh), group=mesh.group)
        return tree

    def one(x):        # a copy: the caller's tensor stays as it was
        t = _tensor(x, mesh.device).clone(
            memory_format=torch.contiguous_format)
        if mesh.group is not None:
            dist.broadcast(t, _src(mesh), group=mesh.group)
        return t
    return _tree_map(one, tree)


def shard_batch_global(batch, mesh: Mesh):
    """Each process passes its own rows of the global batch, in rank
    order (JAX's ``shard_batch_global``): they are its shard already and
    only go to its device."""
    return _tree_map(lambda x: _tensor(x, mesh.device), batch)


def replicate_global(tree, mesh: Mesh):
    """Identical pytrees from every process (JAX's ``replicate_global``),
    on this rank's device; broadcast from rank 0 so that they are."""
    return replicate(tree, mesh)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the mesh, in place; returns it."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (floating) averaged over the mesh, in place; returns it."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
        t.div_(mesh.size)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` [n, ...] concatenated in rank order, [N*n, ...]
    (the global batch of a sharded result). Values pass exactly (a sum
    with zeros; a negative zero comes back positive); bool goes through
    uint8."""
    if mesh.group is None:
        return t
    is_bool = t.dtype == torch.bool
    src = t.to(torch.uint8) if is_bool else t
    n = src.shape[0]
    buf = src.new_zeros((mesh.size * n,) + tuple(src.shape[1:]))
    buf[mesh.rank * n:(mesh.rank + 1) * n] = src
    dist.all_reduce(buf, group=mesh.group)
    return buf.bool() if is_bool else buf


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce of one value on the mesh's
    device, which NCCL and gloo both take)."""
    if mesh.group is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


@contextlib.contextmanager
def rank_zero_first(mesh: Mesh):
    """Rank 0 runs the block first, the other ranks after it has left it
    (writing a shared file, e.g. a dataset tree or its caches, once)."""
    if not mesh.is_main:
        barrier(mesh)
    yield
    if mesh.is_main:
        barrier(mesh)
