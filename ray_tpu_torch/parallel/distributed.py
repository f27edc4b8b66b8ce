"""Multi-process initialization over `torch.distributed`: the port's
counterpart of `ray_tpu/parallel/distributed.py` (jax.distributed).

JAX runs one process per TPU host; the port runs one per card. The
defaults come from the launcher's environment (`MASTER_ADDR`,
`MASTER_PORT`, `WORLD_SIZE`, `RANK`, as torchrun sets them) in place of
`TPU_WORKER_HOSTNAMES` and `TPU_WORKER_ID`. The process group's backend is
`nccl` on `cuda` and `gloo` when the caller passes `device="cpu"`.

Usage on every process of the job:
    ray_tpu_torch.parallel.initialize_multihost()   # env-driven defaults
"""

import os
import socket
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device

_initialized = False


def backend_for(device="cuda") -> str:
    """`nccl` for a CUDA device (which must be visible), `gloo` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> bool:
    """Idempotent process-group bring-up. Returns True when the job has
    more than one process; with one process no group is started.

    `coordinator_address` is `host:port` (made `tcp://host:port`) or a URL
    `init_process_group` takes (`tcp://`, `file://`); it defaults to
    `MASTER_ADDR:MASTER_PORT`. `num_processes` defaults to `WORLD_SIZE`,
    `process_id` to `RANK`. A `cuda` device with no visible card raises."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return process_count() > 1
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes <= 1:
        _initialized = True
        return False
    backend = backend_for(device)
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(
                f"{num_processes} processes need a coordinator: pass "
                f"coordinator_address or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def coordinator_endpoint() -> str:
    """Where rank 0's process-group store will listen, as `host:port`.
    Host: `RAY_TPU_COORD_HOST`, else this host's name if it resolves, else
    127.0.0.1 (correct on one machine only, so it says so). Port: a free
    port the kernel picks."""
    host = os.environ.get("RAY_TPU_COORD_HOST")
    if not host:
        host = socket.gethostname()
        try:
            socket.getaddrinfo(host, None)
        except OSError:
            print(f"[distributed] hostname {host!r} does not resolve; advertising "
                  f"127.0.0.1 as the process-group coordinator. Multi-node "
                  f"runs need resolvable hostnames or RAY_TPU_COORD_HOST.",
                  file=sys.stderr)
            host = "127.0.0.1"
    # bind-close-reuse is a benign race: the store binds the port again
    # within milliseconds, and a collision fails the group's start loudly
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return f"{host}:{port}"


def process_index() -> int:
    """This process's rank; 0 when no process group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count; 1 when no process group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def barrier(name: str = "barrier"):
    """Block until every process arrives (`name` is kept for the JAX
    signature). With one process it waits for this process's card, as
    JAX's single-process barrier waits for its local devices."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    elif torch.cuda.is_available():
        torch.cuda.synchronize()
