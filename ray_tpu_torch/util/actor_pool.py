"""ActorPool (reference: python/ray/util/actor_pool.py) — same surface:
map / map_unordered / submit / get_next / get_next_unordered / has_next /
has_free / push / pop_idle, over actors of the port's runtime.
"""

from typing import Any, Callable, Iterable, List, TypeVar

V = TypeVar("V")


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._actor_of_ref = {}
        self._inflight_by_seq = {}
        self._submit_seq = 0
        self._drain_seq = 0
        self._backlog = []

    # -- submission ----------------------------------------------------------
    def submit(self, fn: Callable[[Any, V], Any], value: V):
        """fn: lambda (actor, value) -> ObjectRef (call an actor method)."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._actor_of_ref[future] = actor
            self._inflight_by_seq[self._submit_seq] = future
            self._submit_seq += 1
        else:
            self._backlog.append((fn, value))

    def _maybe_drain_pending(self):
        while self._idle and self._backlog:
            fn, value = self._backlog.pop(0)
            self.submit(fn, value)

    # -- retrieval -----------------------------------------------------------
    def has_next(self) -> bool:
        return bool(self._inflight_by_seq) or bool(self._backlog)

    def get_next(self, timeout=None):
        """Next result in submission order. Seqs already taken by
        get_next_unordered leave gaps in the inflight map — skip them
        instead of spinning (mixing the two collectors is supported)."""
        import ray_tpu_torch as rt
        if not self.has_next():
            raise StopIteration("no pending results")
        self._maybe_drain_pending()
        idx = self._drain_seq
        while idx < self._submit_seq and idx not in self._inflight_by_seq:
            idx += 1  # submitted but absent → collected unordered
        if idx not in self._inflight_by_seq:
            raise StopIteration("no pending results")
        future = self._inflight_by_seq.pop(idx)
        self._drain_seq = idx + 1
        value = rt.get(future, timeout=timeout)
        self._return_actor(future)
        return value

    def get_next_unordered(self, timeout=None):
        """Whichever pending result finishes first."""
        import ray_tpu_torch as rt
        self._maybe_drain_pending()
        if not self._inflight_by_seq:
            raise StopIteration("no pending results")
        futures = list(self._inflight_by_seq.values())
        ready, _ = rt.wait(futures, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        future = ready[0]
        for i, f in list(self._inflight_by_seq.items()):
            if f == future:
                del self._inflight_by_seq[i]
                if i == self._drain_seq:
                    while self._drain_seq not in self._inflight_by_seq \
                            and self._drain_seq < self._submit_seq:
                        self._drain_seq += 1
                break
        value = rt.get(future)
        self._return_actor(future)
        return value

    def _return_actor(self, future):
        actor = self._actor_of_ref.pop(future, None)
        if actor is not None:
            self._idle.append(actor)
            self._maybe_drain_pending()

    # -- bulk ----------------------------------------------------------------
    def map(self, fn: Callable, values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            self._maybe_drain_pending()
            yield self.get_next_unordered()

    # -- membership ----------------------------------------------------------
    def has_free(self) -> bool:
        return bool(self._idle) and not self._backlog

    def push(self, actor):
        self._idle.append(actor)
        self._maybe_drain_pending()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
