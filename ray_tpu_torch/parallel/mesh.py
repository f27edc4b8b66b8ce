"""Device mesh construction: the port's counterpart of
`ray_tpu/parallel/mesh.py`. Every library (serve, train, the MoE forward)
builds its mesh here, so all agree on the axis names:

  dp    data parallel (batch split, gradient psum)
  fsdp  fully-sharded data parallel (params sharded over this axis too)
  tp    tensor parallel (matmul-dimension sharding)
  sp    sequence/context parallel (ring attention)
  pp    pipeline parallel (stage dimension)
  ep    expert parallel (MoE)

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, on `cuda` (NCCL) unless the caller passes
`device="cpu"` (gloo). With no process group up, a one-process world is
started in memory (or from `WORLD_SIZE`/`MASTER_ADDR`/`MASTER_PORT` when
the launcher set them). Rank r sits where device r sits in JAX's
row-major device array, so a mesh's coordinates match JAX's.

Where the port's SPMD model differs from JAX's single controller:
- JAX's process owns every device of the mesh; here each process is one
  rank and holds only its own coordinate (`mesh.get_coordinate()`), so a
  rank in the port is real, where `ray_tpu.parallel.collective.XlaGroup`'s
  `rank` is only conceptual.
- Building a mesh creates process groups, which every rank of the world
  must do together, in the same order: `make_mesh` is a collective call.
- `devices` names ranks of the world, not device objects.
"""

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.distributed import backend_for, initialize_multihost
from ray_tpu_torch.util.gpu import get_worker_id

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


def mesh_shape(axes: Dict[str, int], n: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of a mesh of `n` devices from {axis: size}:
    names ordered by AXIS_ORDER (others after, in the caller's order), one
    size -1 absorbing the rest. Raises JAX's three ValueErrors."""
    names = [a for a in AXIS_ORDER if a in axes] + [a for a in axes if a not in AXIS_ORDER]
    sizes = {a: axes[a] for a in names}
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"only one axis may be -1, got {wild}")
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(f"mesh axes {sizes} need {total} devices, have {n}")
    return tuple(sizes), tuple(sizes.values())


def ensure_world(device="cuda") -> int:
    """The default process group's size, starting it when none is up: from
    the launcher's environment when `WORLD_SIZE` > 1, else a one-process
    world in memory. A `cuda` device with no visible card raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if not initialize_multihost(device=dev.type):
            dist.init_process_group(backend_for(dev.type), store=dist.HashStore(),
                                    world_size=1, rank=0)
    return dist.get_world_size()


def _device_mesh(device, ranks: np.ndarray, names: Sequence[str]) -> DeviceMesh:
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.as_tensor(np.ascontiguousarray(ranks)),
                      mesh_dim_names=tuple(names))


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None,
              device="cuda") -> DeviceMesh:
    """Build a mesh from {axis_name: size}; size -1 means "absorb the rest".

    Axis order follows AXIS_ORDER so the innermost axes (tp, then ep/sp)
    fall on neighbouring ranks, which torchrun numbers host by host: tp
    stays on one host's NVLink. `devices` are ranks of the world (all of
    them by default), laid out row-major. Every rank of the world calls
    this, members or not."""
    world = ensure_world(device)
    ranks = np.arange(world) if devices is None else np.asarray(list(devices))
    names, sizes = mesh_shape(axes, ranks.size)
    return _device_mesh(device, ranks.reshape(sizes), names)


def auto_mesh(tp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1,
              fsdp: Optional[int] = None, devices=None, device="cuda") -> DeviceMesh:
    """The common recipe: fix model axes, absorb the remainder into dp/fsdp."""
    return make_mesh(auto_axes(tp, pp, sp, ep, fsdp), devices, device)


def auto_axes(tp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1,
              fsdp: Optional[int] = None) -> Dict[str, int]:
    """auto_mesh's {axis: size}, with dp absorbing the rest."""
    axes = {}
    if pp > 1:
        axes["pp"] = pp
    if fsdp is None:
        axes["dp"] = -1
    else:
        axes["fsdp"] = fsdp
        axes["dp"] = -1
    if sp > 1:
        axes["sp"] = sp
    if ep > 1:
        axes["ep"] = ep
    if tp > 1:
        axes["tp"] = tp
    return axes


def hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                device="cuda") -> DeviceMesh:
    """Multi-host: the DCN axes (outer) over hosts, the ICI axes (inner)
    over the cards of a host. A host is a `GROUP_RANK` (torchrun's node
    rank) and a card its `LOCAL_RANK`; every rank reports both, and the
    mesh is [hosts..., cards...] with the axis names in the given order,
    DCN first. The product of the DCN sizes must be the number of hosts
    and that of the ICI sizes the cards a host, as JAX's hybrid mesh
    needs equal granules."""
    world = ensure_world(device)
    me = (get_worker_id(), int(os.environ.get("LOCAL_RANK", 0)), dist.get_rank())
    seen = [None] * world
    dist.all_gather_object(seen, me)
    hosts = sorted({h for h, _, _ in seen})
    per_host = {h: sorted((lr, r) for hh, lr, r in seen if hh == h) for h in hosts}
    n_dcn = int(np.prod(list(dcn_axes.values()) or [1]))
    n_ici = int(np.prod(list(ici_axes.values()) or [1]))
    counts = {len(v) for v in per_host.values()}
    if len(hosts) != n_dcn or counts != {n_ici}:
        raise ValueError(
            f"dcn axes {dcn_axes} x ici axes {ici_axes} need {n_dcn} hosts of {n_ici} "
            f"cards; the world has {len(hosts)} hosts with {sorted(counts)} cards each")
    ranks = np.array([[r for _, r in per_host[h]] for h in hosts])
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    return _device_mesh(device, ranks.reshape(shape), tuple(dcn_axes) + tuple(ici_axes))


def local_cpu_mesh(n: int = 8, axes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A gloo mesh over the first `n` ranks of a CPU world, for tests and
    dry runs (JAX's takes `n` virtual CPU devices). Raises when the world
    has fewer than `n` ranks."""
    world = ensure_world("cpu")
    if world < n:
        raise RuntimeError(
            f"need {n} cpu devices, have {world}; start a gloo world of {n} processes "
            f"(parallel.distributed.initialize_multihost(..., device='cpu')) first")
    return make_mesh(axes or {"dp": n}, list(range(n)), device="cpu")


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}, as JAX's `Mesh.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
