"""Distributed Queue (reference: python/ray/util/queue.py) — an actor-backed
asyncio queue shared across tasks/actors via its handle. The actor is one
of the port's runtime (zero CPUs); its process loads no torch.
"""

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.q = asyncio.Queue(maxsize=maxsize)
        self.maxsize = maxsize

    async def put(self, item, timeout: Optional[float] = None):
        if timeout is None:
            await self.q.put(item)
            return True
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self.q.get()
        try:
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self.maxsize and self.q.qsize() + len(items) > self.maxsize:
            return False
        for i in items:
            self.q.put_nowait(i)
        return True

    def get_nowait_batch(self, n: int):
        if self.q.qsize() < n:
            return False, []
        return True, [self.q.get_nowait() for _ in range(n)]

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    """Driver/worker-side wrapper; pickles by actor handle."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None,
                 _actor=None):
        if _actor is not None:
            self.actor = _actor
            return
        import ray_tpu_torch as rt
        opts = {"num_cpus": 0, "max_concurrency": 64,
                **(actor_options or {})}
        self.actor = rt.remote(**opts)(_QueueActor).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch as rt
        if not block:
            if not rt.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        ok = rt.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full()

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch as rt
        if not block:
            ok, v = rt.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty()
            return v
        ok, v = rt.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return v

    def put_nowait(self, item):
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]):
        import ray_tpu_torch as rt
        if not rt.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full()

    def get_nowait_batch(self, n: int):
        import ray_tpu_torch as rt
        ok, items = rt.get(self.actor.get_nowait_batch.remote(n))
        if not ok:
            raise Empty()
        return items

    def qsize(self) -> int:
        import ray_tpu_torch as rt
        return rt.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        import ray_tpu_torch as rt
        return rt.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch as rt
        return rt.get(self.actor.full.remote())

    def shutdown(self):
        import ray_tpu_torch as rt
        rt.kill(self.actor)

    def __reduce__(self):
        return (Queue, (0, None, self.actor))
