"""@serve.batch — dynamic request coalescing (reference:
python/ray/serve/batching.py).

Decorates an async method taking a LIST of inputs and returning a LIST of
outputs. Concurrent callers are queued; a flush fires when max_batch_size
requests are waiting or batch_wait_timeout_s elapses — this is what turns
many single requests into one padded batch for a single model call.
"""

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.queue: List = []  # (item, future)
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._lock = asyncio.Lock()

    async def submit(self, owner, item: Any):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        async with self._lock:
            self.queue.append((item, fut))
            if len(self.queue) >= self.max_batch_size:
                self._launch_flush(loop, owner)
            elif self._flush_handle is None:
                self._flush_handle = loop.call_later(
                    self.timeout_s,
                    lambda: loop.create_task(self._flush_locked(owner)))
        return await fut

    def _launch_flush(self, loop, owner):
        """Pop the queue NOW (caller holds the lock or runs on the loop) and
        run the batch fn in a separate task — never while holding the lock,
        so the next batch keeps filling during a slow batch execution."""
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if not self.queue:
            return
        batch, self.queue = self.queue, []
        loop.create_task(self._run_batch(owner, batch))

    async def _flush_locked(self, owner):
        async with self._lock:
            self._launch_flush(asyncio.get_running_loop(), owner)

    async def _run_batch(self, owner, batch):
        items = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        try:
            results = await self.fn(owner, items) if owner is not None \
                else await self.fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"batch fn returned {len(results)} results for "
                    f"{len(items)} inputs")
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator; the wrapped coroutine receives a list and returns a list."""

    def wrap(fn: Callable):
        batchers = {}  # per-instance (methods) or single (free fn)

        @functools.wraps(fn)
        async def wrapper(*args):
            # methods arrive as (self, item), free functions as (item,);
            # batch handlers take exactly one item argument by contract
            if len(args) == 2:
                owner, item = args
                key = id(owner)
            elif len(args) == 1:
                owner, item = None, args[0]
                key = 0
            else:
                raise TypeError(
                    "@serve.batch handlers take exactly one request argument")
            b = batchers.get(key)
            if b is None:
                b = batchers[key] = _Batcher(fn, max_batch_size,
                                             batch_wait_timeout_s)
            return await b.submit(owner, item)

        wrapper._batcher_of = fn
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
