"""Collective communication over `torch.distributed`: the port's counterpart
of `ray_tpu/parallel/collective.py` (reference: ray.util.collective).

- backend="host": numpy in, numpy out, per rank, with `HostGroup`'s
  semantics (every reduction, PRODUCT included, is numpy's over the ranks'
  arrays in rank order). It runs over a gloo group in place of the
  rendezvous actor.
- backend="nccl": the GPU path over the whole world. CUDA tensors in,
  CUDA tensors out, per rank, with the operations and block conventions
  of `XlaGroup`: allreduce SUM, MAX and MIN; reducescatter SUM over the
  axis-0 blocks of each rank's tensor; allgather and alltoall over axis-0
  blocks.
- backend="xla": JAX's mesh-axis group. The group is one axis of a
  device mesh (`parallel/mesh.py`; `mesh=None` builds
  `make_mesh({axis: world_size})`), its process group the axis's, and
  its operations those of the nccl backend, run on the mesh's device.
  Where JAX's single controller owns every shard and its `rank` is
  conceptual, each process here is one member and its `rank` is its
  index on the axis. Results are JAX's per rank: reduce gives every rank
  the reduced tensor, as JAX's does, and send/recv raise JAX's error.

Groups are made with `torch.distributed.new_group`, which every rank of
the default process group must call, in the same order: a group spans the
whole default world, and `rank` is the process's rank in it. With no
default process group, `init_collective_group` starts one: in memory for
a group of one, else from `MASTER_ADDR`/`MASTER_PORT`
(`parallel.distributed.initialize_multihost`).

A send to this rank itself is kept in the group's mailbox and returned by
the next recv from this rank, as the reference's rendezvous mailbox does.
`create_collective_group` tells actors to join a group, so it stays with
`ray_tpu`'s runtime.
"""

import collections
import threading
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.distributed import backend_for, initialize_multihost


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"


_NUMPY_REDUCE = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
}

_TORCH_REDUCE = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
                 ReduceOp.MIN: dist.ReduceOp.MIN}

_groups: Dict[str, "BaseGroup"] = {}
_lock = threading.Lock()
_owned_world = False   # this module started the default process group


class BaseGroup:
    """A member's view of a group over the process group `pg`."""

    def __init__(self, world_size: int, rank: int, group_name: str, pg):
        self.world_size = world_size
        self.rank = rank
        self.name = group_name
        self.pg = pg
        self._mailbox = collections.deque()   # sends to this rank itself


class HostGroup(BaseGroup):
    """numpy arrays over a gloo group, with HostGroup's per-rank results."""

    def _gather(self, obj) -> List:
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def _reduced(self, t, op):
        return _NUMPY_REDUCE[op](np.stack(self._gather(np.asarray(t))))

    def allreduce(self, t, op=ReduceOp.SUM):
        return self._reduced(t, op)

    def allgather(self, t):
        return self._gather(np.asarray(t))

    def reducescatter(self, t, op=ReduceOp.SUM):
        return np.array_split(self._reduced(t, op), self.world_size)[self.rank]

    def broadcast(self, t, src_rank=0):
        box = [np.asarray(t) if self.rank == src_rank else None]
        dist.broadcast_object_list(box, src=src_rank, group=self.pg)
        return box[0]

    def reduce(self, t, dst_rank=0, op=ReduceOp.SUM):
        out = self._reduced(t, op)
        return out if self.rank == dst_rank else t

    def barrier(self):
        dist.barrier(group=self.pg)

    def alltoall(self, chunks: List):
        gathered = self._gather([np.asarray(c) for c in chunks])
        return [gathered[src][self.rank] for src in range(self.world_size)]

    def send(self, t, dst_rank: int):
        if dst_rank == self.rank:
            self._mailbox.append(np.array(t))
        else:
            dist.send_object_list([np.asarray(t)], dst=dst_rank, group=self.pg)

    def recv(self, src_rank: int, like=None):
        if src_rank == self.rank:
            return self._mailbox.popleft()
        box = [None]
        dist.recv_object_list(box, src=src_rank, group=self.pg)
        return box[0]


class TensorGroup(BaseGroup):
    """torch tensors in, tensors out, per rank, with XlaGroup's operations
    and block conventions. `backend="nccl"` builds it over an NCCL group
    for CUDA tensors; every call is issued on the current stream.
    `device` holds the barrier's one-element tensor."""

    backend = "nccl"

    def __init__(self, world_size: int, rank: int, group_name: str, pg, device):
        super().__init__(world_size, rank, group_name, pg)
        self.device = device

    def _op(self, op):
        if op not in _TORCH_REDUCE:
            raise ValueError(f"{self.backend} backend does not support op={op}")
        return _TORCH_REDUCE[op]

    def allreduce(self, t, op=ReduceOp.SUM):
        red = self._op(op)
        out = t.clone()
        dist.all_reduce(out, op=red, group=self.pg)
        return out

    def allgather(self, t):
        """Every rank's tensor, concatenated along axis 0 in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.pg)
        return torch.cat(parts)

    def reducescatter(self, t, op=ReduceOp.SUM):
        """Axis-0 block r of the sum over ranks, on rank r."""
        if op != ReduceOp.SUM:
            raise ValueError(f"reducescatter supports SUM on the {self.backend} backend")
        if t.shape[0] % self.world_size:
            raise ValueError(f"axis 0 of {tuple(t.shape)} does not split into "
                             f"{self.world_size} blocks")
        parts = [p.contiguous() for p in t.chunk(self.world_size)]
        out = torch.empty_like(parts[self.rank])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=self.pg)
        return out

    def broadcast(self, t, src_rank=0):
        out = t.clone()
        dist.broadcast(out, src=src_rank, group=self.pg)
        return out

    def reduce(self, t, dst_rank=0, op=ReduceOp.SUM):
        red = self._op(op)
        out = t.clone()
        dist.reduce(out, dst=dst_rank, op=red, group=self.pg)
        return out if self.rank == dst_rank else t

    def barrier(self):
        """An allreduce of one element, waited for on the host."""
        self.allreduce(torch.zeros(1, device=self.device)).cpu()

    def alltoall(self, t):
        """Axis-0 block j of this rank's tensor goes to rank j; block j of
        the result came from rank j."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.pg)
        return out

    def send(self, t, dst_rank: int):
        if dst_rank == self.rank:
            self._mailbox.append(t.clone())
        else:
            dist.send(t.contiguous(), dst=dst_rank, group=self.pg)

    def recv(self, src_rank: int, like=None):
        """`like` gives the shape, dtype and device of the incoming tensor."""
        if src_rank == self.rank:
            return self._mailbox.popleft()
        out = torch.empty_like(like)
        dist.recv(out, src=src_rank, group=self.pg)
        return out


class XlaGroup(TensorGroup):
    """Group = one axis of a device mesh: world_size is the axis's size and
    rank this process's index on it; the tensors are each rank's blocks."""

    backend = "xla"

    def __init__(self, mesh, axis: str, group_name: str):
        from ray_tpu_torch.parallel import xla_ops
        super().__init__(xla_ops.axis_size(axis, mesh), xla_ops.axis_index(axis, mesh),
                         group_name, mesh.get_group(axis), _mesh_device(mesh))
        self.mesh = mesh
        self.axis = axis

    def broadcast(self, t, src_rank=0):
        """Rank `src_rank`'s tensor on every rank (`src_rank` is an axis index)."""
        out = t.clone()
        dist.broadcast(out, src=dist.get_global_rank(self.pg, src_rank), group=self.pg)
        return out

    def reduce(self, t, dst_rank=0, op=ReduceOp.SUM):
        # JAX's single controller returns the reduced array to the caller,
        # whatever dst_rank: every rank gets it here too
        return self.allreduce(t, op)

    def send(self, t, dst_rank: int):
        raise NotImplementedError(
            "xla backend has no eager send/recv (one controller owns all "
            "shards) — use ppermute inside shard_map (parallel.xla_ops) or "
            "backend='host'")

    def recv(self, src_rank: int, like=None):
        raise NotImplementedError(
            "xla backend has no eager send/recv (one controller owns all "
            "shards) — use ppermute inside shard_map (parallel.xla_ops) or "
            "backend='host'")


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _process_group(world_size: int, rank: int, backend: str):
    """The torch process group for a new collective group of `world_size`."""
    global _owned_world
    device = "cuda" if backend == "nccl" else "cpu"
    if not dist.is_initialized():
        if world_size == 1:
            dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                    world_size=1, rank=0)
        else:
            initialize_multihost(num_processes=world_size, process_id=rank, device=device)
        _owned_world = True
    elif backend == "nccl":
        resolve_device("cuda")        # raises when no card is visible
    if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise ValueError(
            f"collective group of world_size={world_size}, rank={rank} in a "
            f"process group of {dist.get_world_size()} processes at rank "
            f"{dist.get_rank()}: a group spans the default world, at the "
            f"process's own rank")
    return dist.new_group(ranks=list(range(world_size)), backend=backend)


def init_collective_group(world_size: int, rank: int, backend: str = "host",
                          group_name: str = "default", mesh=None, axis: str = "dp"):
    """Join group `group_name` as `rank` of `world_size`. backend="xla"
    makes the group axis `axis` of `mesh` (`make_mesh({axis: world_size})`
    over the default world when mesh is None); the other backends span the
    whole default world, and ignore `mesh` and `axis`, as JAX's host
    backend does."""
    if backend not in ("host", "nccl", "xla"):
        raise ValueError(f"unknown backend '{backend}' (host|nccl|xla)")
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group '{group_name}' already initialized")
        if backend == "xla":
            if mesh is None:
                from ray_tpu_torch.parallel.mesh import make_mesh
                mesh = make_mesh({axis: world_size})
            g = XlaGroup(mesh, axis, group_name)
            _groups[group_name] = g
            return g
        pg = _process_group(world_size, rank, "gloo" if backend == "host" else "nccl")
        if backend == "host":
            g = HostGroup(world_size, rank, group_name, pg)
        else:
            g = TensorGroup(world_size, rank, group_name, pg,
                            torch.device("cuda", torch.cuda.current_device()))
        _groups[group_name] = g
        return g


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default"):
    """Leave the group; the default process group this module started goes
    with the last group."""
    global _owned_world
    with _lock:
        g = _groups.pop(group_name, None)
        if g is None:
            return
        if isinstance(g, XlaGroup):
            return                      # the axis's process group is the mesh's
        dist.destroy_process_group(g.pg)
        if _owned_world and not _groups:
            dist.destroy_process_group()
            _owned_world = False


def _get(group_name):
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(f"collective group '{group_name}' is not initialized "
                           f"in this process; call init_collective_group first")
    return g


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def allreduce(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _get(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _get(group_name).broadcast(tensor, src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op=ReduceOp.SUM):
    return _get(group_name).reduce(tensor, dst_rank, op)


def barrier(group_name: str = "default"):
    _get(group_name).barrier()


def alltoall(chunks, group_name: str = "default"):
    return _get(group_name).alltoall(chunks)


def send(tensor, dst_rank: int, group_name: str = "default"):
    _get(group_name).send(tensor, dst_rank)


def recv(tensor_shape_like, src_rank: int, group_name: str = "default"):
    return _get(group_name).recv(src_rank, like=tensor_shape_like)
