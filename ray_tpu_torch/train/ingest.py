"""Host-to-device input pipeline: the port's counterpart of
`ray_tpu/train/ingest.py` (reference: ray.train's iter_torch_batches).

The device should never wait on the host. `iter_device_batches` walks the
batches in a producer thread that copies each one into pinned host memory
and issues its host-to-device copies `non_blocking` on a side stream,
ahead of use, so step N+1's copy overlaps step N's compute. The consumer
makes its current stream wait for the copy's event before it yields the
batch.

With `sharding` (a `parallel.sharding.NamedSharding`, e.g.
`data_sharding(mesh)`), each rank copies only its own block of every
leaf (the batch dimension split over dp and fsdp) the same way, and the
batch comes out as DTensors over the mesh whose `full_tensor()` is the
host batch.
"""

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel import sharding as _sharding


def _map(tree, fn):
    """fn over the leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor over x's data (tensors pass through); a read-only or
    strided array is copied first, as torch.from_numpy needs."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    return torch.from_numpy(a)


def _as_dtensor(local: torch.Tensor, sharding) -> DTensor:
    """The DTensor whose block on this rank is `local`."""
    placements = sharding.placements(local.ndim)
    shape = list(local.shape)
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            shape[pl.dim] *= sharding.mesh.mesh.shape[mesh_dim]
    return DTensor.from_local(local, sharding.mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def iter_device_batches(
    batches: Iterable[Any],
    device="cuda",
    prefetch: int = 2,
    transform: Optional[Callable[[Any], Any]] = None,
    sharding=None,
) -> Iterator[Any]:
    """Yield device-resident trees of tensors from host batches, with
    prefetch.

    batches: iterable of dicts, lists and tuples of numpy arrays.
    device: "cuda" (the default; raises without a card) or "cpu", where
      the batches become CPU tensors with no pinning and no streams.
    prefetch: queue depth; 2 = double buffering.
    transform: host-side fn applied before the copy (e.g. cast/pad).
    sharding: a NamedSharding over a mesh; every leaf becomes a DTensor
      with this rank's block on the mesh's device (`device` is then
      ignored). Each split dimension must divide evenly, as in JAX.

    A producer error is raised here, on the consumer's side.
    """
    if sharding is not None:
        device = sharding.mesh.device_type
        block = lambda x: _sharding.local_slice(
            x, _sharding._clip_spec(sharding.spec, x), sharding.mesh)
    else:
        block = lambda x: x
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    end = object()
    err: list = []

    if dev.type == "cuda":
        copy_stream = torch.cuda.Stream(device=dev)

        def to_device(b):
            # The pinned buffers come from the caching host allocator, which
            # keeps each one until the copy that reads it has finished.
            with torch.cuda.stream(copy_stream):
                out = _map(b, lambda x: block(_host_tensor(x)).pin_memory().to(
                    dev, non_blocking=True))
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return out, ready
    else:
        def to_device(b):
            return _map(b, lambda x: block(_host_tensor(x)).clone()), None

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for b in batches:
                if transform is not None:
                    b = transform(b)
                if not offer(to_device(b)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            err.append(e)
        offer(end)

    t = threading.Thread(target=produce, daemon=True, name="ray_tpu_torch-ingest")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                # the compute stream waits for the copy, and the allocator
                # may not hand the batch's memory (allocated on the copy
                # stream) to another tensor before the compute stream is done
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)
                for x in _leaves(batch):
                    x.record_stream(current)
            if sharding is not None:
                batch = _map(batch, lambda x: _as_dtensor(x, sharding))
            yield batch
    finally:
        stop.set()          # a consumer that stops early releases the producer
        t.join(timeout=10)


def prefetch_iterator(it: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Plain host-side lookahead (no device transfer)."""
    buf = collections.deque()
    it = iter(it)
    try:
        for _ in range(depth):
            buf.append(next(it))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(next(it))
        except StopIteration:
            pass
        yield out
